"""The controls, on the card at each cell's own size: the reference at the
next precision below the configuration's, put in the program's place, has
to come out as not correct against the cell's limits.

    python -m pytest benchmark/tests/test_bench_control.py -q

(on a machine with the card; it skips without one). About 15 s a seed."""

import json

import pytest

from benchmark import calibrate
from benchmark.harness import spec

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
CALLS = 40


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_control_is_not_correct(cell, card):
    limits = spec.Cell(cell).limits["check"]["limits"]
    lines = []
    calibrate.readings(cell, [], SEEDS, CALLS, device=card,
                       out=lines.append)
    readings = [json.loads(s) for s in lines]
    assert len(readings) == len(SEEDS)
    for r in readings:
        print(json.dumps(r))
        assert r["reading"] != "program"
        assert any(r[k] > lim for k, lim in limits.items() if k in r), r
