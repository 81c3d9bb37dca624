"""Finds a cell's parts by name, so that a new cell, configuration,
traffic mix or per-layer metric is new files and new entries only:

- ``BENCHMARK.json`` (the checkout's root): the cell's entry;
- ``configs/<config>.json``: the deployment's sizes;
- ``traffic/<traffic>.json``: the mix's parameters, whose ``unit`` names
  the code that drives one unit of work, ``units/<unit>.py``;
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``.
"""

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def spec(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name, root=ROOT):
    for w in spec(root)["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def data(kind, name, bench=BENCH):
    with open(Path(bench) / kind / f"{name}.json") as f:
        return json.load(f)


def module(kind, name, bench=BENCH):
    """``<kind>/<name>.py``, or where there is none, the file named by
    the part of ``name`` before its first dot: one reader serves
    ``busy_ms.spotless`` and ``busy_ms.fluxmop`` alike."""
    path = Path(bench) / kind / f"{name}.py"
    if not path.exists():
        path = Path(bench) / kind / f"{name.split('.')[0]}.py"
    if not path.exists():
        raise KeyError(f"no {kind[:-1]} {name!r} ({path})")
    mspec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mspec)
    mspec.loader.exec_module(mod)
    return mod


def end_to_end(workload, root=ROOT):
    """The end-to-end metrics that ``workload`` reports."""
    return [m for m in spec(root)["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer(workload, root=ROOT):
    """The per-layer metrics that ``workload`` reports: those that list
    it, and those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(workload, root)}
    return [m for m in spec(root)["per_layer"]
            if workload in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in e2e)]
