"""The benchmark's spans and its reading of a torch.profiler trace.

Spans are the benchmark's own, around its calls into the program's layers:
a name and a duration each, kept in memory. With sync=True (the traced
run) each edge synchronises the card first, so a span holds the device
work it queued; and each span is also a profiler annotation, so the trace
can say which span the host was in while the device sat idle.

profile() runs a bounded slice of the cell's own requests under
torch.profiler and reduces its one timeline to what the metrics read:
the device's busy time (the union of its kernel and copy intervals), the
slice's wall time, each device operation's launches and seconds, and the
idle gaps attributed to what the host was doing (the innermost span and
the innermost host operation over the gap's middle).
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

SLICE = "perfbench.slice"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Named durations in seconds; `sync` makes every edge wait for the
    device."""

    def __init__(self, device, sync: bool = False):
        self.device = device
        self.sync = sync
        self.seconds = collections.defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.sync:
            t0 = time.perf_counter()
            yield
            self.seconds[name].append(time.perf_counter() - t0)
            return
        sync(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            sync(self.device)
        self.seconds[name].append(time.perf_counter() - t0)


def _short(name: str) -> str:
    """A device operation's name without its argument list."""
    cut = name.split("(")[0].strip() if "(" in name else name
    return cut[:160]


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def profile(fn, device) -> dict:
    """Run fn() under torch.profiler (host and, on a card, device
    activities) and reduce the trace. Returns {"busy_s", "window_s",
    "kernels": {name: [launches, seconds]}, "idle_gaps": {what: seconds}}.
    """
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SLICE):
            fn()
            sync(device)
    events = prof.profiler.kineto_results.events()
    dev, host, window = [], [], None
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() != torch.autograd.DeviceType.CPU:
            if not e.is_user_annotation():  # a span's mirror on the device
                dev.append((start, end, e.name()))
        else:
            if e.name() == SLICE:
                window = (start, end)
            else:
                host.append((start, end, e.name(), e.start_thread_id(),
                             e.is_user_annotation()))
    if window is None:
        raise RuntimeError("the profiler lost the slice's annotation")
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for s, e, name in dev:
        k = kernels[name]
        k[0] += 1
        k[1] += (e - s) * 1e-9
    busy = _union((max(s, window[0]), min(e, window[1])) for s, e, _ in dev
                  if e > window[0] and s < window[1])
    busy_ns = sum(e - s for s, e in busy)
    gaps, t = [], window[0]
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if window[1] > t:
        gaps.append((t, window[1]))
    return {"busy_s": busy_ns * 1e-9,
            "window_s": (window[1] - window[0]) * 1e-9,
            "kernels": {n: v for n, v in kernels.items()},
            "idle_gaps": _attribute(gaps, host)}


def _attribute(gaps, host) -> dict:
    """Seconds of idle device time by what the host's main thread was in
    at each gap's middle: "<innermost span> > <innermost operation>"."""
    if not host:
        return {"(no host events)": sum(e - s for s, e in gaps) * 1e-9}
    main = collections.Counter(h[3] for h in host).most_common(1)[0][0]
    ops = sorted((h for h in host if h[3] == main),
                 key=lambda h: (h[0], -h[1]))
    out = collections.defaultdict(float)
    stack, i = [], 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) / 2
        while i < len(ops) and ops[i][0] <= mid:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        live = [h for h in stack if h[1] >= mid]
        span = next((h[2] for h in reversed(live) if h[4]), None)
        op = next((h[2] for h in reversed(live) if not h[4]), None)
        what = " > ".join(v for v in (span, op) if v) or "(between operations)"
        out[what] += (g1 - g0) * 1e-9
    return dict(out)


def breakdown(trace: dict) -> dict:
    """The result line's breakdown: the ten device operations that took
    most time and the ten largest idle shares by host activity."""
    ops = sorted(((_short(n), v[1]) for n, v in trace["kernels"].items()),
                 key=lambda x: -x[1])
    merged = collections.defaultdict(float)
    for n, s in ops:
        merged[n] += s
    top = sorted(merged.items(), key=lambda x: -x[1])[:10]
    gaps = sorted(trace["idle_gaps"].items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}
