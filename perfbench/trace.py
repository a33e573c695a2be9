"""Spans of the harness and the reduction of a profiler trace.

`Tracer.span(name)` times a call into a layer on the host clock, always,
and in a traced run also marks it in the profiler's timeline
(`perfbench.<name>`), so that an idle gap of the device can be labelled
with what the host was doing. `Tracer.traced()` profiles a stretch of the
window (torch.profiler, CPU and CUDA activity); `summary()` reduces it:

  busy_s      length of the union of the device's operations (kernels,
              copies, sets) inside the traced stretch
  window_s    the stretch's length: from the first device operation that
              starts after the first `start_after` span inside the
              `perfbench.traced` span (the traced work's first launch, once
              what a drained pipeline must first stage is staged) to the
              span's end, which waits for the device; or the union of the
              `within` spans inside it when given (the time a server is
              working on requests)
  kernels     device seconds by operation name
  gaps        idle seconds by the innermost harness span that covered the
              gap's start on the host

The union and the interval walk follow the port's own profile script
(`profile_train._busy_us`), copied here so that the yardstick does not
move with it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

PREFIX = "perfbench."


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint, sorted union of (start, end) intervals."""
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def intersect(a, b) -> List[Tuple[float, float]]:
    """Intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


class Tracer:
    """Host spans always; the profiler only when `enabled`."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.cuda = device.type == "cuda"
        self.host: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.prof = None
        self.units = 0          # steps or requests inside the traced stretch

    @contextlib.contextmanager
    def span(self, name: str):
        marker = (torch.profiler.record_function(PREFIX + name)
                  if self.prof is not None else contextlib.nullcontext())
        t0 = time.perf_counter()
        with marker:
            yield
        self.host[name] += time.perf_counter() - t0
        self.calls[name] += 1

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._window = torch.profiler.record_function(PREFIX + "traced")
        self._window.__enter__()

    def stop(self):
        self._sync()
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def summary(self, within: Optional[str] = None,
                start_after: Optional[str] = None) -> Dict:
        """Reduce the traced stretch (see the module docstring)."""
        if self.prof is None:
            return {}
        from torch.autograd import DeviceType
        device, spans = [], defaultdict(list)
        for e in self.prof.events():
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    device.append(e)
            elif e.name.startswith(PREFIX):
                spans[e.name[len(PREFIX):]].append(
                    (e.time_range.start, e.time_range.end))
        lo, hi = spans["traced"][0]
        if within is not None:
            window = union(clip(spans[within], lo, hi))
        else:
            first = min((a for a, _ in spans.get(start_after, [])
                         if a >= lo), default=lo)
            starts = [e.time_range.start for e in device
                      if first <= e.time_range.start < hi]
            window = [(min(starts), hi)] if starts else [(lo, hi)]
        busy = intersect(union(clip([(e.time_range.start, e.time_range.end)
                                     for e in device], lo, hi)), window)
        kernels: Dict[str, float] = defaultdict(float)
        for e in device:
            s, t = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if t > s:
                kernels[e.name] += (t - s) * 1e-6
        gaps: Dict[str, float] = defaultdict(float)
        named = [(a, b, n) for n, iv in spans.items() if n != "traced"
                 for a, b in iv]
        for w0, w1 in window:
            cursor = w0
            for b0, b1 in intersect(busy, [(w0, w1)]) + [(w1, w1)]:
                if b0 > cursor:
                    inner = [(a, n) for a, b, n in named if a <= cursor < b]
                    label = max(inner)[1] if inner else "host"
                    gaps[label] += (b0 - cursor) * 1e-6
                cursor = max(cursor, b1)
        return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
                "window_s": sum(b - a for a, b in window) * 1e-6,
                "kernels": dict(kernels), "gaps": dict(gaps),
                "units": self.units}


def top(d: Dict[str, float], n: int = 10, width: int = 160):
    """The n largest entries as [[name, value], ...], names cut to width."""
    return [[k[:width], v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:n]]


class DeviceTimer:
    """CUDA events around calls, read once the window has closed: the
    device time from the first event to the second, per call."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.pairs: Dict[str, list] = defaultdict(list)
        self._open: Dict[str, object] = {}

    def begin(self, name: str):
        if self.enabled:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._open[name] = ev

    def end(self, name: str):
        if self.enabled:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.pairs[name].append((self._open.pop(name), ev))

    def ms(self, name: str) -> List[float]:
        return [a.elapsed_time(b) for a, b in self.pairs.get(name, [])]
