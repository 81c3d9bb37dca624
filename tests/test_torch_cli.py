"""The port's command line (pfb_tpu_torch/workers/main.py, pipeline.py,
parser/, utils/profiling.py) on the CPU: the counterparts of
tests/test_cli.py, tests/test_cabs.py, the schema test of
tests/test_options.py and the logging test of tests/test_misc_ops.py,
every command's wiring to its worker and to ``--device``, chip_smoke.py
phase 29's recipe against the arguments phase 6 passes, and the JAX CLI
against the port's on one observation in float64: the DIRTY, MODEL and
RESIDUAL cubes within 1e-8 of max and restore's model_mfs.fits within
1e-10 (the files hold float32, which both packages round alike)."""

import glob
import importlib
import inspect
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from pfb_tpu.parser.schemas import defaults_for as defaults_for_j
from pfb_tpu.workers.main import cli as cli_j
from pfb_tpu_torch.parser.schemas import defaults_for, schema
from pfb_tpu_torch.utils import dstore
from pfb_tpu_torch.utils.fits import load_fits
from pfb_tpu_torch.utils.ms import simulate_ms
from pfb_tpu_torch.workers.main import cli
from pfb_tpu_torch.workers.pipeline import (_WORKERS, load_recipe,
                                            resolve_recipe, run_recipe,
                                            worker_args)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
PARSER = REPO / "pfb_tpu_torch" / "parser"
WORKERS = ("init", "grid", "klean", "spotless", "model2comps", "degrid",
           "restore", "fluxmop", "fastim", "smoovie", "fwdbwd")
CPU = ["--device", "cpu"]
# tests/test_cli.py:14's commands after the group's options
STEPS = [["grid", "-fov", "0.3", "-rob", "0.0"],
         ["klean", "-niter", "2", "--threshold", "1e-4", "--gamma", "0.1",
          "--peak-factor", "0.75", "--no-mop-flux"],
         ["restore", "--outputs", "mr"]]


def _ms(tmp_path, seed=17, **kw):
    ms = str(tmp_path / "obs.npz")
    sim = dict(nant=7, ntime=4, nchan=2, nsource=2, fov_deg=0.3, seed=seed)
    sim.update(kw)
    simulate_ms(ms, **sim)
    return ms


def _invoke(c, args):
    r = CliRunner().invoke(c, args)
    assert r.exit_code == 0, (r.output, r.exception)
    return r


def _run_cli(c, pre, ms, out):
    _invoke(c, pre + ["init", "-ms", ms, "-o", out, "--channels-per-image",
                      "1"])
    for step in STEPS:
        _invoke(c, pre + step[:1] + ["-o", out] + step[1:])


def test_cli_init_grid_klean_restore(tmp_path):
    ms = _ms(tmp_path)
    out = str(tmp_path / "out")
    _run_cli(cli, CPU, ms, out)
    assert glob.glob(out + "_I.xds/ds_*")
    assert glob.glob(out + "_I_main.dds/ds_*")
    assert glob.glob(str(tmp_path / "*model_mfs.fits"))


def test_cli_matches_jax_cli(tmp_path):
    """The same init -> grid -> klean -> restore through both CLIs, float64
    (init's default precision) on the CPU."""
    ms = _ms(tmp_path)
    outs = {}
    for tag, c, pre in (("j", cli_j, []), ("t", cli, CPU)):
        (tmp_path / tag).mkdir()
        outs[tag] = str(tmp_path / tag / "out")
        _run_cli(c, pre, ms, outs[tag])
    dj = dstore.read_store(outs["j"] + "_I_main.dds")
    dt = dstore.read_store(outs["t"] + "_I_main.dds")
    for key in ("DIRTY", "MODEL", "RESIDUAL"):
        a = np.stack([d[key] for d in dj])
        b = np.stack([d[key] for d in dt])
        assert a.dtype == b.dtype == np.float64
        assert np.abs(b - a).max() <= 1e-8 * np.abs(a).max(), key
    fj = load_fits(outs["j"] + "_I_main_model_mfs.fits")
    ft = load_fits(outs["t"] + "_I_main_model_mfs.fits")
    assert np.abs(fj).max() > 0
    assert np.abs(ft - fj).max() <= 1e-10 * np.abs(fj).max()
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())


def test_cli_help_lists_all_workers():
    r = _invoke(cli, ["--help"])
    for w in WORKERS + ("pipeline",):
        assert w in r.output
    assert set(cli.commands) == set(WORKERS) | {"pipeline"}
    for opt in ("--profile-dir", "--coordinator", "--num-processes",
                "--process-id", "--device"):
        assert opt in r.output


def test_pipeline_recipe(tmp_path):
    ms = _ms(tmp_path, seed=23)
    out = str(tmp_path / "out")
    recipe = tmp_path / "recipe.yaml"
    recipe.write_text(f"""
steps:
  - worker: init
    params: {{ms: {ms}, output-filename: {out},
             channels-per-image: 1}}
  - worker: grid
    params: {{output-filename: {out}, field-of-view: 0.3,
             robustness: 0.0}}
  - worker: klean
    params: {{output-filename: {out}, niter: 2, threshold: 1.0e-4,
             gamma: 0.1, peak-factor: 0.75, mop-flux: false}}
""")
    run_recipe(str(recipe), verbose=0, device="cpu")
    assert glob.glob(out + "_I_main.dds/ds_*")

    bad = tmp_path / "bad.yaml"
    bad.write_text("steps:\n  - worker: nosuch\n")
    with pytest.raises(ValueError, match="unknown worker"):
        load_recipe(str(bad))
    bad2 = tmp_path / "bad2.yaml"
    bad2.write_text("steps:\n  - worker: klean\n"
                    "    params: {nonsense-param: 1}\n")
    with pytest.raises(ValueError, match="unknown parameter"):
        load_recipe(str(bad2))


def test_pipeline_checks_every_step_before_running_any(tmp_path,
                                                       monkeypatch):
    """A bad last step refuses the recipe before its first step runs."""
    calls = []
    monkeypatch.setattr("pfb_tpu_torch.workers.init._init",
                        lambda **kw: calls.append(kw))
    recipe = tmp_path / "r.yaml"
    recipe.write_text("steps:\n  - worker: init\n    params: {ms: a}\n"
                      "  - worker: grid\n    params: {no-such: 1}\n")
    with pytest.raises(ValueError, match="step 1"):
        run_recipe(str(recipe))
    assert calls == []


def test_cli_profile_dir(tmp_path):
    """--profile-dir writes a torch.profiler Chrome trace of the run."""
    from pfb_tpu_torch.utils.profiling import stop_profile
    ms = _ms(tmp_path, seed=3, ntime=2, nchan=1, nsource=1)
    out = str(tmp_path / "out")
    prof = tmp_path / "prof"
    _invoke(cli, CPU + ["--profile-dir", str(prof), "init", "-ms", ms, "-o",
                        out])
    path = stop_profile()
    assert path is not None and Path(path).parent == prof
    found = [p for p in prof.rglob("*") if p.is_file()]
    assert found, "no trace files written"
    events = json.loads(Path(path).read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert stop_profile() is None


@pytest.mark.parametrize("worker", WORKERS)
def test_command_passes_schema_args_and_device(worker, monkeypatch):
    """Each command calls its worker with the schema defaults (the
    schema's filter-extreme-counts as the workers' *_flag argument) and
    the group's --device."""
    mod, fn = _WORKERS[worker]
    got = {}
    monkeypatch.setattr(importlib.import_module(mod), fn,
                        lambda **kw: got.update(kw))
    req = []
    for key, field in schema[worker]["inputs"].items():
        if field.get("required"):
            req += [f"--{key}", "x"]
    _invoke(cli, ["--device", "cpu", worker] + req)
    assert got.pop("device") == "cpu"
    want = worker_args(worker, {k.lstrip("-"): v
                                for k, v in zip(req[::2], req[1::2])})
    want.pop("log_directory")
    assert got == want
    if "filter_extreme_counts" in defaults_for(worker):
        assert "filter_extreme_counts_flag" in got


def test_recipe_renames_filter_extreme_counts(tmp_path):
    """A recipe's filter-extreme-counts reaches _grid as
    filter_extreme_counts_flag, as the grid command's does (the JAX
    package's run_recipe passes it under the schema name, where _grid
    takes it as an unknown keyword and drops it)."""
    recipe = tmp_path / "r.yaml"
    recipe.write_text("steps:\n  - worker: grid\n    params: "
                      "{output-filename: o, filter-extreme-counts: true}\n")
    (worker, args), = resolve_recipe(str(recipe))
    assert args["filter_extreme_counts_flag"] is True
    assert "filter_extreme_counts" not in args
    assert "filter_extreme_counts_flag" in \
        inspect.signature(importlib.import_module(
            "pfb_tpu_torch.workers.grid")._grid).parameters


def test_chip_smoke_recipe_is_phase_6(tmp_path):
    """chip_smoke.py phase 29's recipe resolves to the arguments phase 6
    passes to _init, _grid and _spotless (their defaults overlaid with
    INIT, GRID_PG and SPOT_PG): the same computation. Schema options a
    worker does not take fall into its **kw and are ignored."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    recipe = tmp_path / "r.yaml"
    recipe.write_text(cs.cli_recipe("obs.npz", "out", cs.NX))
    steps = resolve_recipe(str(recipe))
    assert [w for w, _ in steps] == list(cs.CLI_STAGES)
    phase6 = {"init": cs.INIT, "grid": cs.GRID_PG,
              "spotless": dict(cs.SPOT_PG, verbose=0)}
    # what the caller gives: the data, where it goes, the device
    caller = {"ms", "xdsi", "ddsi", "output_filename", "write", "device",
              "devices", "stats"}
    for worker, args in steps:
        mod, fn = _WORKERS[worker]
        sig = inspect.signature(getattr(importlib.import_module(mod), fn))
        for name, p in sig.parameters.items():
            if p.kind is p.VAR_KEYWORD or name in caller:
                continue
            want = phase6[worker].get(name, p.default)
            assert name in args, (worker, name)
            assert args[name] == want, (worker, name, args[name], want)
    assert steps[0][1]["ms"] == "obs.npz"
    assert all(a["output_filename"] == "out" for _, a in steps)


@pytest.mark.parametrize("worker", WORKERS)
def test_defaults_equal_the_jax_package(worker):
    assert defaults_for(worker) == defaults_for_j(worker)


def test_schema_files_are_the_jax_package_s():
    """Every schema and mixin byte for byte; the cabs' commands point at
    the port's CLI, nothing else differs."""
    src = REPO / "pfb_tpu" / "parser"
    names = sorted(p.name for p in src.glob("*.y*ml"))
    assert names == sorted(p.name for p in PARSER.glob("*.y*ml"))
    for n in names:
        a, b = (src / n).read_text(), (PARSER / n).read_text()
        if n == "uncabbedcabs.yml":
            a = a.replace("command: pfb_tpu.workers.main.",
                          "command: pfb_tpu_torch.workers.main.")
        assert a == b, n


def _load_cabs():
    with open(PARSER / "uncabbedcabs.yml") as fh:
        return yaml.safe_load(fh)


def test_every_worker_has_a_cab():
    cabs = _load_cabs()
    workers = set(cli.commands) - {"pipeline"}
    assert {c.split(".", 1)[1] for c in cabs} == workers


def test_cab_commands_importable_and_includes_exist():
    for name, cab in _load_cabs().items():
        assert cab["flavour"] == "python", name
        assert cab["command"].startswith("pfb_tpu_torch.workers.main.")
        mod, attr = cab["command"].rsplit(".", 1)
        fn = getattr(importlib.import_module(mod), attr)
        assert callable(fn) and fn is cli.commands[attr], cab["command"]
        for inc in cab["_include"]:
            assert (PARSER / inc.replace("(.)", "")).exists(), inc


def test_cab_schemas_are_stimela_shaped():
    for name, cab in _load_cabs().items():
        path = cab["_include"][0].replace("(.)", "")
        with open(PARSER / path) as fh:
            spec = yaml.safe_load(fh)
        assert "inputs" in spec, name
        params = {k: v for k, v in spec["inputs"].items()
                  if k != "_include"}
        assert params, name
        for pname, p in params.items():
            assert "dtype" in p, (name, pname)


def test_schema_mixins_resolved():
    inputs = schema["klean"]["inputs"]
    assert "_include" not in inputs
    assert "cg-tol" in inputs and "epsilon" in inputs
    assert "log-directory" in inputs
    # worker override beats the mixin default
    assert schema["fwdbwd"]["inputs"]["cg-tol"]["default"] == 1e-4
    d = defaults_for("spotless")
    assert d["pd_report_freq"] == 50 and d["do_wgridding"] is True


def test_logging_and_profiling(tmp_path):
    import logging

    from pfb_tpu_torch.utils.logging import get_logger, log_to_file
    log = get_logger("TEST")
    fname = log_to_file(str(tmp_path / "run.log"))
    log.info("hello")
    logging.getLogger("pfb_tpu_torch").handlers[-1].flush()
    assert "hello" in open(fname).read()


def test_cli_log_directory(tmp_path):
    """--log-directory attaches a per-run log file named after the
    worker."""
    ms = _ms(tmp_path, seed=5, ntime=2, nchan=1, nsource=1)
    ldir = tmp_path / "logs"
    _invoke(cli, CPU + ["init", "-ms", ms, "-o", str(tmp_path / "o"),
                        "--log-directory", str(ldir)])
    assert [p.name.startswith("init_") for p in ldir.iterdir()] == [True]


def test_module_runs_as_a_script():
    import subprocess
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, "-m", "pfb_tpu_torch.workers.main",
                        "--help"], capture_output=True, text=True,
                       timeout=120, env=env)
    assert p.returncode == 0, p.stderr
    assert all(w in p.stdout for w in WORKERS)


def test_chip_smoke_constants_are_assigned_once():
    """Each module-level name of chip_smoke.py is bound once: a second
    binding silently changes an earlier phase's gate (phase 28's snapshot
    tolerance once rebound phase 16's STOL from 1e-6 to 1e-5)."""
    import ast
    import collections
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = collections.Counter(
        t.id for node in tree.body if isinstance(node, ast.Assign)
        for t in node.targets if isinstance(t, ast.Name))
    assert [n for n, c in names.items() if c > 1] == []
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    assert cs.STOL == 1e-6 and cs.SNAPTOL == 1e-5
