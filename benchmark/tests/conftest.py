"""The benchmark's CPU tests: run from the checkout's root with
``python -m pytest benchmark/tests -q``; ``cuda`` tests skip without a
card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# small frames of the same walk, for the program's and the reference's
# plain paths on the CPU
TINY_TRAFFIC = {"entry": "online", "height": 64, "width": 96,
                "octaves": [[16, 1.0], [4, 0.5]], "poses": 4,
                "schedule": "pingpong",
                "step": {"theta": 0.002, "scale": 0.002, "tx": 0.5,
                         "ty": -0.4, "px": 0.0, "py": 0.0},
                "target_frac": 0.5, "warmup_calls": 1, "trace_calls": 2}


@pytest.fixture
def two_threads():
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# The speed tier's cell, whose files are kept for a later PR that lists
# it in BENCHMARK.json (PERF.md, open questions): its parts as that entry
# would find them.
FAST_CELL = {"name": "woft_fast-720p-online", "config": "woft_fast",
             "traffic": "online-720p", "chips": 1, "why": "pending"}
FAST_CONFIG = {"name": "woft_fast", "source": "pending",
               "file": "benchmark/configs/woft_fast.json", "reduced": [],
               "why": "pending"}


def with_fast_cell(bench):
    """``bench`` with the speed tier's cell and configuration added."""
    return {**bench, "configs": bench["configs"] + [FAST_CONFIG],
            "workloads": bench["workloads"] + [FAST_CELL]}
