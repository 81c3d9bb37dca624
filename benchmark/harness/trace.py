"""What the traced run reads: spans around the calls the workers make
into each layer (recorded from the benchmark's own wrappers), the
program's launch counters, and the device's intervals from
torch.profiler (busy union, time by kernel, idle gaps by what the host
was doing)."""

import bisect
import functools
import time
from collections import defaultdict


class Spans:
    """Host-clock spans by name, each ending in a synchronise, and
    counts by name. ``wrap`` marks the span for the profiler too, so an
    idle gap can be told by the span it fell in."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds = defaultdict(list)
        self.counts = defaultdict(int)
        self.notes = {}

    def wrap(self, fn, name, after=None):
        import torch

        @functools.wraps(fn)
        def timed(*a, **kw):
            self.sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*a, **kw)
                self.sync()
            self.seconds[name].append(time.perf_counter() - t0)
            if after is not None:
                after(self, out)
            return out
        return timed

    def wrap_maker(self, maker, name, made_name, after=None):
        """Span ``name`` around a constructor, ``made_name`` around each
        call of what it returns (its attributes kept)."""
        def make(*a, **kw):
            made = self.wrap(maker, name)(*a, **kw)
            timed = self.wrap(made, made_name, after)
            timed.__dict__.update(getattr(made, "__dict__", {}))
            return timed
        return make


def busy_union(intervals):
    """Seconds covered by the union of (start, end) microsecond
    intervals, and the merged intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged) * 1e-6, merged


# a kernel's name as the breakdown keeps it (a template's arguments run
# to a thousand characters)
NAME_CHARS = 160


def read_profile(prof, span_names=(), top=10):
    """(busy_s, by_kernel {name: [seconds, count]}, device_ops, idle_gaps)
    of a finished torch.profiler run: kernel, copy and set intervals on
    the device; each gap between them named by the benchmark's span
    around its middle and the host's innermost operation there. Reads
    the profiler's raw events: ``prof.events()`` builds a tree of every
    host operation, which over a window of some 10^5 launches takes
    minutes."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    dev, host, spans = [], [], []
    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in res.events():
        a, b = e.start_ns(), e.end_ns()
        if b <= a:
            continue
        a, b, name = (a - t0) * 1e-3, (b - t0) * 1e-3, e.name()
        if e.device_type().name == "CUDA":
            # the spans' own ranges on the device's timeline are no work
            if name in span_names or e.is_user_annotation():
                continue
            dev.append((a, b))
            name = name[:NAME_CHARS]
            by_kernel[name][0] += (b - a) * 1e-6
            by_kernel[name][1] += 1
        elif name in span_names:
            spans.append((a, b, name))
        else:
            host.append((a, b, name))
    busy, merged = busy_union(dev)
    host.sort()
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    for (a0, b0), (a1, b1) in zip(merged, merged[1:]):
        mid = 0.5 * (b0 + a1)
        # the innermost host operation around the gap's middle: the last
        # to start before it that is still running, among the last
        # hundred to start
        inner = None
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 101), -1):
            if host[j][1] >= mid:
                inner = host[j][2]
                break
        outer = [(e - s, n) for s, e, n in spans if s <= mid <= e]
        label = "/".join(([min(outer)[1]] if outer else ["worker"]) +
                         ([inner] if inner else []))
        gaps[label] += (a1 - b0) * 1e-6
    device_ops = sorted(([n, v[0]] for n, v in by_kernel.items()),
                        key=lambda t: -t[1])[:top]
    idle = sorted(([n, s] for n, s in gaps.items()), key=lambda t: -t[1])
    return busy, dict(by_kernel), device_ops, idle[:top]
