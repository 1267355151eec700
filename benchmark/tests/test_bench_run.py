"""A whole run on the CPU at a small size (the program's and the
reference's plain paths), the check catching a broken program, and the
guards.

The runs call ``run.run_cell`` with ``device='cpu'``, which skips the
command's look for a card and nothing else."""

import json
import shutil
import subprocess
import sys
from dataclasses import replace

import pytest
import torch

from benchmark import run
from benchmark.harness import spec

from .conftest import ROOT, TINY_TRAFFIC, with_fast_cell

CELL = "woft-720p-online"
SEED = 2**31 + 11          # above 32 signed bits, as the driver's are


def tiny_run(cell=CELL, seconds=0.5, trace=0, bench=None):
    return run.run_cell(cell, SEED, seconds, trace, device="cpu",
                        traffic=TINY_TRAFFIC, log=lambda s: None,
                        bench=bench)


@pytest.mark.parametrize("cell", ["woft-720p-online",
                                  "woft_fast-720p-online"])
def test_whole_run_is_correct(cell, two_threads):
    """Each cell, and the speed tier's kept for a later PR."""
    bench = with_fast_cell(spec.benchmark())
    r = tiny_run(cell, bench=bench)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"target_frames_per_s", "frame_ms_p95",
                                 "setup_s"}
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(
        spec.Cell(cell, bench=bench).limits["check"]["limits"])
    assert r["device"]["platform"] == "cpu"
    json.dumps(r)


def _broken(monkeypatch, fault):
    """Break the program's tracker step underneath the entry."""
    import woft_tpu_torch.tracker.woft as woft

    real = woft.build_track_step

    def build(raft_cfg, tp, flow_fn=None):
        step = real(raft_cfg, tp, flow_fn)

        def broken(model, state, frame):
            new, H, meta = step(model, state, frame)
            if fault == "state unchanged":
                return state, H, meta
            # the answer altered where it is produced: shifted 5 px, kept
            # consistently in the state and the diagnostics
            shift = torch.eye(3, dtype=H.dtype, device=H.device)
            shift[0, 2] = 5.0
            H = shift @ H
            meta = {**meta, "H_global_cur2init": H}
            new = replace(new, prev_h2init=H,
                          last_good_h2init=H if meta["global_H_success"]
                          else new.last_good_h2init)
            return new, H, meta
        return broken
    monkeypatch.setattr(woft, "build_track_step", build)


@pytest.mark.parametrize("fault", ["state unchanged", "answer altered"])
def test_a_broken_step_is_not_correct(fault, monkeypatch, two_threads):
    _broken(monkeypatch, fault)
    r = tiny_run()
    assert not r["correct"]
    c = r["checks"]
    if fault == "state unchanged":
        assert c["ladder_breaks"]["value"] > 0
    else:
        assert c["h_gap_median_px"]["value"] > c["h_gap_median_px"]["limit"]


def test_traced_run_on_the_cpu_has_no_trace():
    """The profiler's window needs the card; on the CPU a traced run
    stops before printing anything."""
    with pytest.raises(Exception):
        tiny_run(trace=1)


def test_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("woft_tpu_torch", "woft_tpu_torch.ops", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    run.guard("now")
    for name in ("jax", "woft_tpu.tracker", "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == ["flax", "jax", "jaxlib", "woft_tpu"]
    with pytest.raises(ImportError, match="jax"):
        run.guard("now")


def test_a_run_loads_no_jax(two_threads):
    """The program and the harness in a fresh process: a whole run, then
    the top-level module names."""
    code = ("import sys, torch; torch.set_num_threads(2); "
            f"sys.path.insert(0, {str(ROOT)!r}); "
            "from benchmark import run; "
            "from benchmark.tests.conftest import TINY_TRAFFIC; "
            f"r = run.run_cell({CELL!r}, 5, 0.2, 0, device='cpu', "
            "traffic=TINY_TRAFFIC, log=lambda s: None); "
            "print(r['correct'], run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["True", "[]"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files:
    the run stops, non-zero, printing nothing."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); "
            "from benchmark import run; "
            "from benchmark.tests.conftest import TINY_TRAFFIC; "
            f"print(run.run_cell({CELL!r}, 1, 0.2, 0, device='cpu', "
            "traffic=TINY_TRAFFIC))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout == ""
    assert "woft_tpu_torch" in out.stderr
