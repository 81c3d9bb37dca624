"""The port's own spans and counters (pfb_tpu_torch/utils/profiling.py)
on the CPU: off without a profiler (no record, no counter, no
``record_function``), their tree and ids under one, the copy, iteration
and readback counts, the spotless and fluxmop span trees (outputs bit
for bit those of an untraced call), the CLI's ``--profile-dir`` trace,
and the benchmark's readers of them (benchmark/metrics/*.py, loaded by
path) on a hand-made tracer state."""

import importlib.util
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from torch.profiler import ProfilerActivity, profile

from pfb_tpu_torch import config
from pfb_tpu_torch.opt.pcg import pcg
from pfb_tpu_torch.opt.power_method import power_method
from pfb_tpu_torch.opt.primal_dual import primal_dual, primal_dual_hostloop
from pfb_tpu_torch.utils import profiling
from pfb_tpu_torch.utils.ms import simulate_ms
from pfb_tpu_torch.workers.fluxmop import _fluxmop
from pfb_tpu_torch.workers.grid import _grid
from pfb_tpu_torch.workers.init import _init
from pfb_tpu_torch.workers.main import cli
from pfb_tpu_torch.workers.spotless import _spotless

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "benchmark"


def traced():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def dds(tmp_path_factory):
    """Two bands of a tiny observation gridded by pg at 128^2."""
    ms = str(tmp_path_factory.mktemp("trace") / "o.npz")
    simulate_ms(ms, nant=5, ntime=2, nchan=2, nsource=1, fov_deg=0.1,
                seed=1)
    xds = _init(ms=ms, write=False, device="cpu", channels_per_image=1)
    return _grid(xdsi=xds, write=False, device="cpu", nx=128, backend="pg",
                 robustness=0.0, psf=True, residual=False)


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("a.b", device=torch.device("cpu"), k=1)
    with first, profiling.span("a.c"):
        profiling.count("a.n", 5)
    assert profiling.span("a.d") is first  # the shared no-op
    assert profiling.records() == [] and profiling.counters() == {}


def test_spans_nest_with_parent_and_root_ids():
    with traced():
        with profiling.span("w.call", mode="x"):
            with profiling.span("w.a"):
                with profiling.span("w.a1"):
                    pass
            with profiling.span("w.b"):
                profiling.count("w.n")
                profiling.count("w.n", 2)
        with profiling.span("w.call"):
            pass
    by = {}
    for r in profiling.records():
        by.setdefault(r.name, []).append(r)
    root = by["w.call"][0]
    assert root.parent is None and root.root == root.id
    assert root.attrs == {"mode": "x"}
    assert by["w.a"][0].parent == root.id == by["w.b"][0].parent
    assert by["w.a1"][0].parent == by["w.a"][0].id
    assert {r.root for n in ("w.a", "w.a1", "w.b") for r in by[n]} == \
        {root.id}
    second = by["w.call"][1]
    assert second.root == second.id != root.id
    assert all(r.t1 >= r.t0 and r.device_ms is None
               for r in profiling.records())
    assert root.t0 <= by["w.a"][0].t0 <= by["w.b"][0].t1 <= root.t1
    assert profiling.counters() == {"w.n": 3}


def test_copy_bytes_equal_the_arrays_bytes(dds):
    """to_host counts a tensor's bytes; the fluxmop worker's copies are
    the mask times the beam, the residual and the final model up, the
    update and the exact residual down, each (nband, nx, ny) float64."""
    xs = [torch.zeros((3, 5), dtype=dt) for dt in
          (torch.float32, torch.complex64, torch.int32, torch.float64)]
    with traced():
        for x in xs:
            config.to_host(x)
    assert profiling.counters() == {"copy.d2h_bytes": 15 * (4 + 8 + 4 + 8),
                                    "sync.d2h": 4}
    profiling.reset()
    with traced():
        _fluxmop(ddsi=[dict(d) for d in dds], write=False, device="cpu",
                 backend="pg", use_psf=False, cg_maxit=2, cg_minit=2,
                 verbose=0)
    cube = len(dds) * 128 * 128 * 8
    c = profiling.counters()
    assert c["copy.h2d_bytes"] == 3 * cube and c["sync.h2d"] == 3
    assert c["copy.d2h_bytes"] == 2 * cube and c["sync.d2h"] == 2


def test_solver_iteration_and_sync_counts():
    g = torch.Generator().manual_seed(0)
    d = torch.rand(2, 6, 6, generator=g, dtype=torch.float64) + 0.5
    x0 = torch.rand(2, 6, 6, generator=g, dtype=torch.float64)
    v0 = torch.zeros(2, 6, 6, dtype=torch.float64)
    w = torch.ones(6, 6, dtype=torch.float64)
    one = torch.ones(2, 6, 6, dtype=torch.float64)

    def ident(z):
        return z

    def grad(z):
        return d * z - one

    with traced():
        power_method(lambda z: d * z, (2, 6, 6), tol=0.0, maxit=7,
                     generator=g, dtype=torch.float64, device="cpu")
    assert profiling.counters() == {"pm.iters": 7, "sync.pm.eps": 7}
    parts = {n: 5 for n in ("sara.analysis", "sara.prox", "sara.synthesis",
                            "pd.grad")}
    profiling.reset()
    with traced():
        primal_dual(x0, v0, 0.1, ident, ident, 2.0, w, grad, tol=0.0,
                    maxit=5)
    assert profiling.counters() == {"pd.iters": 5, "sync.pd.eps": 5}
    assert Counter(r.name for r in profiling.records()) == parts
    profiling.reset()
    # the host loop reads eps at iterations 2, 4 and the last
    with traced():
        primal_dual_hostloop(x0, v0, 0.1, ident, ident, 2.0, w, grad,
                             tol=1e-30, maxit=5, check_freq=2)
    assert profiling.counters() == {"pd.iters": 5, "sync.pd.eps": 3}
    assert Counter(r.name for r in profiling.records()) == parts
    profiling.reset()
    # on 2 I the first step solves the system: no backtrack after it
    with traced():
        pcg(lambda z: 2.0 * z, one, tol=0.0, maxit=3, minit=3)
    assert profiling.counters() == {"pcg.iters": 3, "sync.pcg.eps": 3,
                                    "sync.pcg.backtrack": 3}


def _tree(recs):
    kids = {}
    for r in recs:
        kids.setdefault(r.parent, []).append(r)
    return kids


def test_spotless_span_tree_and_untraced_output(dds):
    kw = dict(write=False, device="cpu", engine="pallas", niter=2,
              pd_maxit=3, pd_tol=0.0, pm_maxit=3, backend="pg", verbose=0)
    m0, r0 = _spotless(ddsi=[dict(d) for d in dds], **kw)
    with traced():
        m1, r1 = _spotless(ddsi=[dict(d) for d in dds], **kw)
    np.testing.assert_array_equal(m1, m0)
    np.testing.assert_array_equal(r1, r0)
    recs = profiling.records()
    kids = _tree(recs)
    (root,) = kids[None]
    assert root.name == "spotless.call"
    assert {r.root for r in recs} == {root.id}
    assert [r.name for r in kids[root.id]] == [
        "spotless.cubes", "spotless.psf_prep", "spotless.power_method",
        "spotless.sara_setup", "spotless.plan", "spotless.pd_setup",
        "spotless.major", "spotless.major", "spotless.host"]
    majors = [r for r in kids[root.id] if r.name == "spotless.major"]
    assert [r.attrs for r in majors] == [{"k": 0}, {"k": 1}]
    for m in majors:
        assert [r.name for r in kids[m.id]] == [
            "spotless.data", "spotless.pd", "spotless.residual",
            "spotless.host"]
    c = profiling.counters()
    assert c["pd.iters"] == c["sync.pd.eps"] == 6
    assert c["pm.iters"] == 3
    # one exact-residual application a major, each band's spread once
    assert c["pg.applications"] == 2
    assert c["sync.pg.colour_perm"] == 2 * len(dds)
    names = Counter(r.name for r in recs)
    assert names["pg.spread_fold"] == names["pg.degrid"] == 2 * len(dds)
    assert names["pg.wplanes"] == 4 * len(dds)
    assert names["sara.prox"] == 6


def test_fluxmop_span_tree_and_untraced_output(dds):
    kw = dict(write=False, device="cpu", backend="pg", use_psf=False,
              cg_maxit=3, cg_minit=3, verbose=0)
    out0 = _fluxmop(ddsi=[dict(d) for d in dds], **kw)
    with traced():
        out1 = _fluxmop(ddsi=[dict(d) for d in dds], **kw)
    for a, b in zip(out1, out0):
        np.testing.assert_array_equal(a, b)
    recs = profiling.records()
    kids = _tree(recs)
    (root,) = kids[None]
    assert root.name == "fluxmop.call"
    assert [r.name for r in kids[root.id]] == [
        "fluxmop.cubes", "fluxmop.plan", "fluxmop.host", "fluxmop.pcg",
        "fluxmop.host", "fluxmop.residual", "fluxmop.host"]
    plans = [r for r in recs if r.name == "fluxmop.plan"]
    assert [r.attrs for r in plans] == [{"which": "exact"},
                                        {"which": "pcg"}]
    pcg_span = kids[root.id][3]
    assert plans[1].parent == pcg_span.id
    # the pg plans: the shared geometry's host part, then a plan a band
    for p in plans:
        assert [r.name for r in kids[p.id]] == \
            ["pg.plan.host"] + ["pg.plan.host", "pg.plan.upload",
                                "pg.plan.upload"] * len(dds)
    c = profiling.counters()
    # PCG: A x0, three A p, then the exact residual's application
    assert c["pg.applications"] == 5
    assert c["pcg.iters"] == c["sync.pcg.eps"] == 3
    assert c["sync.pg.colour_perm"] == 5 * len(dds)


def test_cli_profile_dir_trace_holds_the_worker_spans(tmp_path):
    ms = str(tmp_path / "obs.npz")
    simulate_ms(ms, nant=5, ntime=2, nchan=1, nsource=1, fov_deg=0.1,
                seed=3)
    out = str(tmp_path / "out")
    prof = tmp_path / "prof"
    for args in (["init", "-ms", ms, "-o", out],
                 ["grid", "-o", out, "-fov", "0.1", "-rob", "0.0"],
                 ["--profile-dir", str(prof), "fluxmop", "-o", out,
                  "--cg-maxit", "2"]):
        r = CliRunner().invoke(cli, ["--device", "cpu"] + args)
        assert r.exit_code == 0, (r.output, r.exception)
    path = profiling.stop_profile()
    assert path is not None and Path(path).parent == prof
    trace = json.loads(Path(path).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"fluxmop.call", "fluxmop.pcg", "fluxmop.residual"} <= names
    assert trace["pfb_counters"]["copy.h2d_bytes"] > 0
    # the records, with their ids, roots and attributes, then forgotten
    spans = trace["pfb_spans"]
    (root,) = [r for r in spans if r["parent"] is None]
    assert root["name"] == "fluxmop.call" and root["root"] == root["id"]
    assert {r["root"] for r in spans} == {root["id"]}
    # the CLI's PCG runs on the PSF: one plan, the exact residual's
    assert [r["attrs"] for r in spans if r["name"] == "fluxmop.plan"] == \
        [{"which": "exact"}]
    assert all(r["host_ms"] >= 0 and r["device_ms"] is None for r in spans)
    assert profiling.records() == [] and profiling.counters() == {}


def test_profile_dir_trace_starts_afresh(tmp_path):
    """A second trace in one process holds only its own spans and
    counts."""
    profiling.start_profile(str(tmp_path), name="a")
    with profiling.span("x.first"):
        profiling.count("x.n", 2)
    profiling.start_profile(str(tmp_path), name="b")  # ends trace a
    with profiling.span("x.second"):
        profiling.count("x.n")
    b = json.loads(Path(profiling.stop_profile()).read_text())
    assert b["pfb_counters"] == {"x.n": 1}
    assert [r["name"] for r in b["pfb_spans"]] == ["x.second"]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"trace_reader_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    spec.loader.exec_module(mod)
    return mod


def _rec(name, i, parent, t0, t1, device_ms=None, root=1, **attrs):
    r = profiling.Record(name, i, parent, i if parent is None else root,
                         attrs)
    r.t0, r.t1 = int(t0 * 1e6), int(t1 * 1e6)  # ms -> ns
    r.device_ms = device_ms
    return r


# a hand-made state: one spotless call of 2 majors and one fluxmop
# call (ms on the host)
STATE = [
    _rec("spotless.cubes", 2, 1, 0, 30),
    _rec("spotless.power_method", 3, 1, 30, 50),
    _rec("pg.plan.host", 5, 4, 52, 70),
    _rec("pg.plan.upload", 6, 4, 70, 72),
    _rec("spotless.plan", 4, 1, 51, 73),
    _rec("sara.analysis", 8, 7, 80, 81, device_ms=2.0),
    _rec("sara.prox", 9, 7, 81, 82, device_ms=1.0),
    _rec("pd.grad", 10, 7, 82, 83, device_ms=4.0),
    _rec("pg.wplanes", 11, 7, 83, 84, device_ms=6.0),
    _rec("pg.spread_fold", 13, 7, 84, 85, device_ms=3.0),
    _rec("pg.degrid", 14, 7, 85, 86, device_ms=5.0),
    _rec("spotless.major", 7, 1, 75, 90),
    _rec("spotless.host", 12, 1, 90, 95),
    _rec("spotless.call", 1, None, 0, 100),
    _rec("fluxmop.plan", 22, 21, 110, 130, root=20, which="pcg"),
    _rec("fluxmop.pcg", 21, 20, 105, 150, root=20),
    _rec("fluxmop.call", 20, None, 100, 160),
]
COUNTS = {"pd.iters": 3, "pg.applications": 2, "copy.h2d_bytes": 3 << 20,
          "copy.d2h_bytes": 1 << 20, "sync.pd.eps": 3, "sync.d2h": 5,
          "pm.iters": 4, "pcg.iters": 5}
UNITS = 2
# per reader: what it reads from STATE over UNITS units
EXPECT = {
    # roots 100 + 60 ms less their children 30 + 20 + 22 + 15 + 5 and 45
    "worker_self_ms": (160 - 137) / UNITS,
    "host_cubes_ms": (30 + 5) / UNITS,
    "pm_ms": 20 / UNITS,
    "sara_ms": (2.0 + 1.0) / 3,
    "copy_mib": 4.0 / UNITS,
    "syncs": 8 / UNITS,
    # pg.plan.host's 18 ms over the two plan spans
    "plan_host_s": 0.009,
    "wplane_ms": 6.0 / 2,
    "spread_fold_ms": 3.0 / 2,
    "degrid_ms": 5.0 / 2,
    "psf_grad_ms": 4.0 / 3,
    "pm_iter_ms": 20 / 4,
    # the PCG span less its operator's construction
    "pcg_iter_ms": (45 - 20) / 5,
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_reads_the_program_tracer(name, monkeypatch):
    reader = _reader(name)
    ctx = dict(units=UNITS)
    monkeypatch.setattr(profiling, "records", lambda: list(STATE))
    monkeypatch.setattr(profiling, "counters", lambda: dict(COUNTS))
    assert reader.read(ctx) == pytest.approx(EXPECT[name], rel=1e-12)
    # nothing traced: no number
    monkeypatch.setattr(profiling, "records", list)
    monkeypatch.setattr(profiling, "counters", dict)
    assert reader.read(ctx) is None
    # a program without the tracer (a checkout from before it)
    monkeypatch.delattr(profiling, "records")
    assert reader.read(ctx) is None


def test_every_new_reader_is_tested_and_declared():
    """Each reader of a program span or counter has a case above and an
    entry in BENCHMARK.json, whose cells it lists."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    readers = {m["name"].split(".")[0] for m in spec["per_layer"]
               if m["source"] == "program_span"
               and not (BENCH / "metrics" / f"{m['name']}.py").exists()}
    old = {"pd_iter_ms", "vis_hessian_ms", "plan_s"}
    assert readers - old == set(EXPECT)
    for m in spec["per_layer"]:
        if m["name"].split(".")[0] in EXPECT:
            assert m["workloads"], m["name"]
