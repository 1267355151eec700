"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells and the metrics. Each part is a file of its own under
``benchmark/``, found by its name:

- a configuration: the file its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``, whose ``entry`` names the
  driver of the program it feeds (``entries/<entry>.py``);
- a cell's correctness limits: ``workloads/<cell>.json``;
- a metric: ``metrics/<name>.py``, whose ``read(run)`` returns its value
  in its unit, or None where the run has nothing to read.
"""

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # benchmark/
ROOT = HERE.parent                                   # the checkout


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def _by_name(entries, name, what):
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries in "
                       "BENCHMARK.json")
    return found[0]


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, str(path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One cell of ``BENCHMARK.json`` with its parts loaded: ``workload``
    (its entry), ``config`` (the configuration file's contents),
    ``traffic``, ``limits`` (``workloads/<cell>.json``), ``entry`` (the
    driver module), and the metrics it reports with each ``--trace``
    setting (``metrics(trace)``: [(entry, module)]). ``bench``: the
    benchmark's contents (default ``BENCHMARK.json``'s), where a test
    holds a cell that the file does not list yet."""

    def __init__(self, name, root=ROOT, bench=None):
        self.root = Path(root)
        bench = benchmark(root) if bench is None else bench
        self.bench = bench
        self.workload = _by_name(bench["workloads"], name, "cell")
        cfg = _by_name(bench["configs"], self.workload["config"],
                       "configuration")
        self.config = load_json(self.root / cfg["file"])
        self.traffic = load_json(HERE / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.limits = load_json(HERE / "workloads" / f"{name}.json")
        self.entry = load_module(HERE / "entries"
                                 / f"{self.traffic['entry']}.py",
                                 f"benchmark_entry_{self.traffic['entry']}")
        self.name = name

    def metrics(self, trace):
        """The metric entries this cell reports with ``--trace`` set as
        given, each with its reader."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        out = []
        for m in group:
            if "workloads" in m and self.name not in m["workloads"]:
                continue
            out.append((m, load_module(HERE / "metrics" / f"{m['name']}.py",
                                       f"benchmark_metric_{m['name']}")))
        return out
