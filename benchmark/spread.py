#!/usr/bin/env python3
"""The spread of a cell's end-to-end metrics over sets of runs.

    python3 benchmark/spread.py SET_A_DIR SET_B_DIR [...]

Each directory holds the result lines of one set of runs (``*.json``, the
last line of each run's standard output). For each metric and set: the
median, and the spread, the distance between the first and third quartile
(``statistics.quantiles(n=4)``) as a share of the median; also the spread
with each set's run farthest from its median left out, and five times the
widest spread (the bound it suggests, never under 1 %).
"""

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmark.harness.stats import spread  # noqa: E402


def results(directory):
    out = []
    for p in sorted(Path(directory).glob("*.json")):
        lines = p.read_text().strip().splitlines()
        if lines:
            out.append(json.loads(lines[-1]))
    return out


def main(dirs):
    sets = [results(d) for d in dirs]
    names = sorted({m for s in sets for r in s for m in r["metrics"]})
    report = {}
    for name in names:
        rows = []
        for s in sets:
            v = [r["metrics"][name]["value"] for r in s
                 if name in r["metrics"]]
            med = statistics.median(v)
            far = max(range(len(v)), key=lambda i: abs(v[i] - med))
            rest = v[:far] + v[far + 1:]
            rows.append({"n": len(v), "median": med, "spread": spread(v),
                         "spread_without_farthest": spread(rest),
                         "correct": sum(r["correct"] for r in s)})
        widest = max(r["spread"] for r in rows)
        report[name] = {"sets": rows, "widest": widest,
                        "five_times": max(0.01, 5 * widest)}
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main(sys.argv[1:])
