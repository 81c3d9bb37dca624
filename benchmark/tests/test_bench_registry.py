"""Cells, configurations, traffic mixes and per-layer metrics are found
by name, and a new one is new files and new entries only."""

import hashlib
import json
import shutil

import pytest

from bench_helpers import BENCH
from harness import main, registry


def test_cells_found_by_name():
    for w in registry.spec()["workloads"]:
        p = main.parts(w["name"])
        assert p["cfg"]["nx"] > 0 and p["traffic"]["unit"]
        assert hasattr(p["unit"], "setup") and hasattr(p["unit"], "check")
        assert set(p["limits"]) and p["end_to_end"]
        names = {m["name"] for m in p["end_to_end"]}
        assert "setup_s" in names and p["traffic"]["rate_metric"] in names
        assert p["per_layer"]
        for m, reader in p["per_layer"]:
            assert callable(reader.read), m["name"]
    for c in registry.spec()["configs"]:
        assert (BENCH.parent / c["file"]).exists()


def _digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_added_files_are_found_without_edits(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digest(bench)
    cfg = registry.data("configs", "syn64_2k", bench)
    (bench / "configs" / "syn64_1k.json").write_text(
        json.dumps(dict(cfg, nx=1024)))
    traffic = registry.data("traffic", "spotless", bench)
    (bench / "traffic" / "spotless_short.json").write_text(
        json.dumps(dict(traffic, call=dict(traffic["call"], niter=1))))
    (bench / "limits" / "syn64_1k.spotless_short.json").write_text(
        json.dumps({"model_gap": 1.0, "resid_gap": 1.0}))
    (bench / "metrics" / "calls_per_window.py").write_text(
        "def read(ctx):\n    return float(ctx['calls'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="syn64_1k",
                                file="benchmark/configs/syn64_1k.json"))
    spec["workloads"].append(dict(name="syn64_1k.spotless_short",
                                  config="syn64_1k",
                                  traffic="spotless_short", chips=1,
                                  why="a test cell"))
    spec["end_to_end"][1]["workloads"].append("syn64_1k.spotless_short")
    spec["per_layer"].append(dict(
        name="calls_per_window", unit="1", better="higher",
        source="program_counter", layer="workers", moves="major_s",
        workloads=["syn64_1k.spotless_short"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    p = main.parts("syn64_1k.spotless_short", root=root, bench=bench)
    assert p["cfg"]["nx"] == 1024 and p["traffic"]["call"]["niter"] == 1
    assert p["limits"] == {"model_gap": 1.0, "resid_gap": 1.0}
    readers = {m["name"]: r for m, r in p["per_layer"]}
    assert list(readers) == ["calls_per_window"]
    assert readers["calls_per_window"].read({"calls": 3}) == 3.0
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_metric_falls_back_to_the_name_before_its_first_dot(tmp_path):
    bench = tmp_path / "benchmark"
    (bench / "metrics").mkdir(parents=True)
    (bench / "metrics" / "busy_ms.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    (bench / "metrics" / "busy_ms.train.py").write_text(
        "def read(ctx):\n    return 2.0\n")
    for name, want in (("busy_ms.spotless", 1.0), ("busy_ms", 1.0),
                       ("busy_ms.train", 2.0)):
        assert registry.module("metrics", name, bench).read({}) == want
    with pytest.raises(KeyError):
        registry.module("metrics", "idle_share.spotless", bench)
