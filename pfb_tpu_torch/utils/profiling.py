"""Profiling hooks (counterpart of pfb_tpu/utils/profiling.py).

Two pieces, both on torch.profiler's clock:

- One ``torch.profiler`` trace per worker run, exported as a Chrome
  trace under ``profile_dir`` (the reference's per-run dask
  performance_report): :func:`start_profile` keeps its profiler on a
  module-level handle so that :func:`stop_profile` (called by tests and
  chip_smoke.py, or at interpreter exit) can finish and export it. The
  profiler records CPU activity, and CUDA activity too when a card is
  visible.
- The program's own spans and counters (:func:`span`, :func:`count`),
  on exactly while a torch profiler runs (``--profile-dir``, or any
  ``torch.profiler.profile`` a caller opens). Off, each costs one flag
  check. On, a span enters ``record_function`` (so it sits on the
  profiler's timeline beside the device's work) and keeps a
  :class:`Record` in memory; a counter adds to an in-memory sum. No span
  synchronises: a span with ``device`` on a CUDA device brackets its
  work with two CUDA events, resolved only when :func:`records` is read.
  The exported trace holds the spans (host and device ranges, as
  ``record_function`` puts them there) and, in its metadata, the
  counters (``pfb_counters``) and every span's record with its device
  milliseconds (``pfb_spans``).

Span names are dotted, ``<layer>.<stage>`` (``spotless.major``,
``pd.grad``, ``pg.wplanes``); counters ``<layer>.<what>`` and
``sync.<site>`` for a blocking readback. PERF.md §3 lists them with the
benchmark metric that reads each.
"""

import atexit
import contextlib
import functools
import itertools
import json
import os
import time

import torch

_active = None  # (profiler, trace path) of the run started by start_profile
_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class Record:
    """A finished span: ``name``; ``id``, ``parent`` (None at a root)
    and ``root`` (the id of the outermost span it ran in, its own at a
    root: the spans of one worker call share it); ``t0``, ``t1``
    (``time.perf_counter_ns``); ``attrs``; ``device_ms`` (the CUDA
    events' interval on the current stream of the span's device, None
    for a host span, set by :func:`records`)."""

    __slots__ = ("name", "id", "parent", "root", "t0", "t1", "attrs",
                 "device_ms", "events")

    def __init__(self, name, id, parent, root, attrs):
        self.name, self.id, self.parent, self.root = name, id, parent, root
        self.attrs = attrs
        self.t0 = self.t1 = 0
        self.device_ms = None
        self.events = None

    @property
    def host_ms(self):
        return (self.t1 - self.t0) * 1e-6

    def as_dict(self):
        return dict(name=self.name, id=self.id, parent=self.parent,
                    root=self.root, attrs=self.attrs, host_ms=self.host_ms,
                    device_ms=self.device_ms)


class _Tracer:
    """The process's spans (finished, and the stack of open ones) and
    counters."""

    def __init__(self):
        self.records = []
        self.counts = {}
        self.stack = []
        self.ids = itertools.count(1)


_tracer = _Tracer()


class _Span:
    __slots__ = ("name", "device", "attrs", "rec", "rf")

    def __init__(self, name, device, attrs):
        self.name, self.device, self.attrs = name, device, attrs

    def __enter__(self):
        stack = _tracer.stack
        i = next(_tracer.ids)
        rec = self.rec = Record(self.name, i,
                                stack[-1].id if stack else None,
                                stack[0].id if stack else i, self.attrs)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if self.device is not None and self.device.type == "cuda":
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(torch.cuda.current_stream(self.device))
        stack.append(rec)
        rec.t0 = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1 = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record(torch.cuda.current_stream(self.device))
        _tracer.stack.pop()
        _tracer.records.append(rec)
        self.rf.__exit__(*exc)
        return False


def span(name, device=None, **attrs):
    """Context manager of one span of the program's work, recorded while
    a torch profiler runs (else a shared no-op, after one flag check).
    ``device``: the torch.device the span's work runs on; a CUDA device
    adds the device interval between two CUDA events. ``attrs`` are kept
    on the record."""
    if not _enabled():
        return _OFF
    return _Span(name, device, attrs)


def traced(name):
    """Decorator: every call of the function runs in span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*a, **kw):
            with span(name):
                return fn(*a, **kw)
        return call
    return wrap


def count(name, n=1):
    """Add ``n`` to counter ``name`` while a torch profiler runs."""
    if _enabled():
        _tracer.counts[name] = _tracer.counts.get(name, 0) + n


def records():
    """The finished spans in the order they ended. Waits for the end
    event of each device span not yet resolved, and frees its events."""
    for r in _tracer.records:
        if r.events is not None:
            r.events[1].synchronize()
            r.device_ms = r.events[0].elapsed_time(r.events[1])
            r.events = None
    return list(_tracer.records)


def counters():
    return dict(_tracer.counts)


def reset():
    """Forget the finished spans and the counters."""
    _tracer.records.clear()
    _tracer.counts.clear()


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _trace_path(profile_dir, name):
    os.makedirs(profile_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    return os.path.join(profile_dir,
                        f"{name}_{stamp}_{os.getpid()}.pt.trace.json")


def start_profile(profile_dir, name="pfb"):
    """Start a torch.profiler trace for the rest of the process (one trace
    per worker invocation), written by :func:`stop_profile` or at
    interpreter exit. Wired to the CLI's ``--profile-dir`` flag. Returns
    the path the trace will be written to."""
    global _active
    from torch.profiler import profile
    stop_profile()
    reset()
    prof = profile(activities=_activities())
    prof.start()
    _active = (prof, _trace_path(profile_dir, name))
    return _active[1]


def stop_profile():
    """Stop the trace of :func:`start_profile` and export it, with the
    counters (``pfb_counters``) and the spans' records (``pfb_spans``)
    in its metadata, then forget both; returns its path (None when no
    trace was running)."""
    global _active
    if _active is None:
        return None
    prof, path = _active
    _active = None
    prof.add_metadata_json("pfb_counters", json.dumps(counters()))
    prof.add_metadata_json("pfb_spans",
                           json.dumps([r.as_dict() for r in records()]))
    prof.stop()
    prof.export_chrome_trace(path)
    reset()
    return path


atexit.register(stop_profile)
