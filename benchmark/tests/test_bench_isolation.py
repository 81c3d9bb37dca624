"""What the benchmark runs loads neither JAX nor the JAX package, the
reference loads nothing of the program, and a run without a card, or
without the program, fails and prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_helpers import BENCH

PY = f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]\n"


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", PY + code + (
        "\nimport json; print(json.dumps(sorted({m.split('.')[0] for m in "
        "sys.modules})))")], capture_output=True, text=True, check=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _modules_after(
        "from harness import main, registry\n"
        "for w in registry.spec()['workloads']:\n"
        "    main.parts(w['name'])\n"
        "main.launch_counters()\n"
        "import pfb_tpu_torch.workers.spotless, pfb_tpu_torch.workers.grid\n"
        "import pfb_tpu_torch.workers.init, pfb_tpu_torch.workers.fluxmop\n")
    assert "pfb_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "pfb_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        "import reference.nufft, reference.sara, reference.imaging\n"
        "import reference.spotless\n"
        "import pkgutil, importlib, reference\n"
        "for m in pkgutil.iter_modules(reference.__path__):\n"
        "    importlib.import_module('reference.' + m.name)\n")
    assert not mods & {"jax", "jaxlib", "flax", "pfb_tpu", "pfb_tpu_torch"}


def _run(cwd, env):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "syn64_2k.spotless", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=env)


def test_no_card_fails_without_result():
    r = _run(BENCH.parent, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_without_the_program_fails(tmp_path):
    root = tmp_path / "only"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root)
    r = _run(root, dict(os.environ))
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    if r.returncode not in (2,):  # with a card: the program is missing
        assert "pfb_tpu_torch" in r.stderr


@pytest.mark.gpu
def test_card_run_without_program_fails(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    test_without_the_program_fails(tmp_path)
