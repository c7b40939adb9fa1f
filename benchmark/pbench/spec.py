"""BENCHMARK.json and the files a cell names, found by name.

  a configuration:  the `file` its BENCHMARK.json entry gives
                    (benchmark/configs/<config>.json);
  a traffic mix:    <harness>/traffic/<traffic>.json;
  a mix's entry:    <harness>/entries/<entry>.py, a module whose class
                    `Entry` runs the mix's requests (pbench/cell.py::Cell);
  a per-layer metric's reader: <harness>/metrics/<metric>.py, a module
                    with read(ctx) -> a number, or None where the run
                    holds nothing for it to read.

<harness> is the first of BENCHMARK.json's `paths`. A later change adds a
cell, a configuration, a mix or a metric by adding such files and entries;
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class SpecError(ValueError):
    pass


def load(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def harness_dir(root: Path, spec: dict) -> Path:
    return Path(root) / spec["paths"][0]


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def config(root: Path, spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(Path(root) / c["file"]) as f:
                return json.load(f)
    raise SpecError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(root: Path, spec: dict, name: str) -> dict:
    path = harness_dir(root, spec) / "traffic" / f"{name}.json"
    if not path.is_file():
        raise SpecError(f"no traffic mix file {path}")
    with open(path) as f:
        return json.load(f)


def entry(root: Path, spec: dict, name: str):
    """The Entry class of an entry file, which a traffic mix names."""
    path = harness_dir(root, spec) / "entries" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no entry file {path} for entry {name!r}")
    return _load(path, f"pbench_entry_{name}").Entry


def applies(metric: dict, workload_name: str) -> bool:
    """Whether a metric is reported in a cell: the cells its `workloads`
    lists, or every cell where it has none."""
    return workload_name in metric.get("workloads", [workload_name])


def reader(root: Path, spec: dict, metric: str):
    """The read(ctx) function of a per-layer metric's reader file."""
    path = harness_dir(root, spec) / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise SpecError(f"no reader file {path} for metric {metric!r}")
    return _load(path, f"pbench_metric_{metric.replace('.', '_')}").read


def _load(path: Path, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module
