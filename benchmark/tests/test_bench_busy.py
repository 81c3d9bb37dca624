"""The busy union against scripts/profile_torch_dist.py:busy_fraction,
and the metric arithmetic: a window's rate over whole units, the idle
share, the roofline share."""

import importlib.util
import types

import pytest

from bench_helpers import BENCH
from harness import registry
from harness.roofline import bound, conv_work
from harness.trace import Spans, busy_union, read_profile

INTERVALS = [(0.0, 10.0), (5.0, 12.0), (20.0, 30.0), (25.0, 26.0),
             (40.0, 41.5), (41.5, 50.0), (100.0, 101.0)]


def _event(a, b, dev="CUDA", name="k"):
    return types.SimpleNamespace(
        time_range=types.SimpleNamespace(start=a, end=b),
        device_type=types.SimpleNamespace(name=dev), name=name)


class _FakeProfile:
    def __init__(self, *a, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def events(self):
        return [_event(a, b) for a, b in INTERVALS] + \
            [_event(0.0, 200.0, "CPU", "aten::add")]


def test_busy_union_matches_profile_script(monkeypatch):
    import torch.profiler
    spec = importlib.util.spec_from_file_location(
        "profile_torch_dist", BENCH.parent / "scripts" /
        "profile_torch_dist.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    busy, _ = mod.busy_fraction(lambda: None, lambda: None)
    mine, merged = busy_union(INTERVALS)
    assert mine == pytest.approx(busy, rel=1e-15)
    assert mine == pytest.approx(33e-6)
    assert [tuple(m) for m in merged] == [(0.0, 12.0), (20.0, 30.0),
                                          (40.0, 50.0), (100.0, 101.0)]


class _RawEvent:
    """A torch profiler raw event at microseconds ``a`` to ``b``."""

    def __init__(self, a, b, dev="CUDA", name="k", annotation=False):
        self.a, self.b, self.dev, self.n = a, b, dev, name
        self.annotation = annotation

    def start_ns(self):
        return 5000 + int(self.a * 1e3)

    def end_ns(self):
        return 5000 + int(self.b * 1e3)

    def name(self):
        return self.n

    def device_type(self):
        return types.SimpleNamespace(name=self.dev)

    def is_user_annotation(self):
        return self.annotation


def test_read_profile_from_raw_events():
    """Busy union, time by kernel, and each gap named by the span and the
    innermost host operation around its middle."""
    events = [_RawEvent(a, b) for a, b in INTERVALS] + [
        _RawEvent(0.0, 60.0, "CPU", "pd"),
        _RawEvent(0.0, 60.0, "CUDA", "pd", annotation=True),
        _RawEvent(11.0, 45.0, "CPU", "aten::add"),
        _RawEvent(14.0, 15.0, "CPU", "cudaLaunchKernel"),
        _RawEvent(90.0, 95.0, "CPU", "aten::copy_"),
        _RawEvent(50.0, 50.0, "CUDA", "empty")]
    res = types.SimpleNamespace(trace_start_ns=lambda: 5000,
                                events=lambda: events)
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=res))
    busy, by_kernel, ops, idle = read_profile(prof, {"pd"})
    assert busy == pytest.approx(33e-6)
    assert by_kernel == {"k": [pytest.approx(39e-6), 7]}
    assert ops == [["k", pytest.approx(39e-6)]]
    assert dict(idle) == {"pd/aten::add": pytest.approx(18e-6),
                          "worker": pytest.approx(50e-6)}


def _ctx(**kw):
    sp = Spans(lambda: None)
    ctx = dict(spans=sp, launches={}, by_kernel={}, busy_s=0.0,
               window_s=0.0, units=0, calls=0)
    ctx.update(kw)
    return ctx, sp


@pytest.mark.parametrize("name,value", [
    ("idle_share.spotless", 25.0), ("idle_share.fluxmop", 25.0),
    ("busy_ms.spotless", 1000.0), ("busy_ms.fluxmop", 1000.0)])
def test_device_shares(name, value):
    ctx, _ = _ctx(busy_s=3.0, window_s=4.0, units=3)
    assert registry.module("metrics", name).read(ctx) == pytest.approx(value)


def test_rates_over_whole_units():
    ctx, sp = _ctx(window_s=12.0, units=3)
    sp.seconds["pd"] = [2.0, 2.0, 2.0]
    sp.seconds["vis_hessian"] = [0.5, 0.5, 0.5]
    sp.counts["pd_iters"] = 300
    rd = lambda n: registry.module("metrics", n).read(ctx)  # noqa: E731
    assert rd("pd_iter_ms") == pytest.approx(20.0)
    assert rd("vis_hessian_ms.spotless") == pytest.approx(500.0)
    assert rd("worker_rest_ms.spotless") == pytest.approx(1500.0)


def test_roofline_share_and_silence():
    work = conv_work(8, 2048, 2048, 4096, 4096, 8 * 2049 * 4096, True)
    ctx, sp = _ctx(launches={"K1": 10},
                   by_kernel={"void psf_cols_fwd_kernel<4>(float*)":
                              [0.004, 10],
                              "psf_rows_fused_kernel": [0.004, 10],
                              "psf_cols_inv_kernel": [0.002, 10],
                              "fftx_c2c_rows": [1.0, 10]})
    read = registry.module("metrics", "psf_hessian_roofline").read
    assert read(ctx) is None
    sp.notes.update(psf_work=work, psf_counter="K1")
    assert read(ctx) == pytest.approx(100 * bound(*work)[0] / 1.0)
    ctx["launches"] = {"K1": 0}
    assert read(ctx) is None
    for name in ("pd_iter_ms", "vis_hessian_ms.spotless", "plan_s.spotless",
                 "idle_share.spotless"):
        assert registry.module("metrics", name).read(_ctx()[0]) is None
