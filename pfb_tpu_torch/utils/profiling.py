"""Profiling hooks (counterpart of pfb_tpu/utils/profiling.py).

One ``torch.profiler`` trace per worker run, exported as a Chrome trace
under ``profile_dir`` (the reference's per-run dask performance_report),
and wall-clock phase timers that synchronise by reading one scalar back
from the device, as the JAX package's do.

The profiler records CPU activity, and CUDA activity too when a card is
visible. ``start_profile`` keeps its profiler on a module-level handle so
that ``stop_profile`` (called by tests and chip_smoke.py, or at
interpreter exit) can finish and export it.
"""

import atexit
import contextlib
import os
import time

_active = None  # (profiler, trace path) of the run started by start_profile


def _activities():
    import torch
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
    prof = profile(activities=_activities())
    prof.start()
    _active = (prof, _trace_path(profile_dir, name))
    return _active[1]


def stop_profile():
    """Stop the trace of :func:`start_profile` and export it; returns its
    path (None when no trace was running)."""
    global _active
    if _active is None:
        return None
    prof, path = _active
    _active = None
    prof.stop()
    prof.export_chrome_trace(path)
    return path


atexit.register(stop_profile)


@contextlib.contextmanager
def compute_context(profile_dir=None, name="pfb"):
    """Optional torch.profiler trace around a worker phase, exported under
    ``profile_dir`` when the phase ends."""
    if not profile_dir:
        yield
        return
    from torch.profiler import profile
    path = _trace_path(profile_dir, name)
    with profile(activities=_activities()) as prof:
        yield
    prof.export_chrome_trace(path)


class PhaseTimer:
    """Accumulating wall timers keyed by phase name."""

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def __call__(self, phase, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                import torch
                float(torch.sum(torch.as_tensor(sync_value)))
            self.times[phase] = self.times.get(phase, 0.0) + \
                time.perf_counter() - t0

    def report(self):
        return dict(sorted(self.times.items(), key=lambda kv: -kv[1]))
