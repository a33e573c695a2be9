"""Profiling and device observability.

Port of `vae_teb_tpu.utils.profiling` on PyTorch:

  trace(log_dir)         torch.profiler trace of a code region, exported
                         as a Chrome / Perfetto trace (trace.json)
  StepTimer              per-section wall times -> the same report format
  device_memory_stats    memory in use per visible CUDA device, in MB
  find_max_batch_size    largest power-of-two batch that fits (OOM probe)
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_trace: bool = True):
    """Profile the enclosed region with torch.profiler (the CPU, and the
    CUDA devices when present) and write `log_dir`/trace.json, a Chrome
    trace that Perfetto opens. The profile object is yielded, so a caller
    can also read its `key_averages()`. `create_perfetto_trace=False`
    skips the file."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if create_perfetto_trace:
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Accumulate wall-times per named section and emit a report file, in
    the JAX package's format."""

    def __init__(self):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._totals[name] += time.perf_counter() - t0
            self._counts[name] += 1

    def report(self) -> str:
        lines = [f"{'section':30s} {'calls':>8s} {'total_s':>10s} "
                 f"{'mean_ms':>10s}"]
        for name in sorted(self._totals, key=self._totals.get, reverse=True):
            tot, cnt = self._totals[name], self._counts[name]
            lines.append(f"{name:30s} {cnt:8d} {tot:10.3f} "
                         f"{1000 * tot / max(cnt, 1):10.2f}")
        return "\n".join(lines)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.report() + "\n")


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """{device name: {"mb_in_use", "peak_mb_in_use", "mb_limit"}} for each
    visible CUDA device (`torch.cuda.memory_stats`: allocated bytes;
    `mem_get_info`: the card's total), the JAX package's MB keys. Without
    a card the CPU's entry is empty, as the JAX CPU backend reports no
    statistics."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    mb = 1024.0 ** 2
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "mb_in_use": stats.get("allocated_bytes.all.current", 0) / mb,
            "peak_mb_in_use": stats.get("allocated_bytes.all.peak", 0) / mb,
            "mb_limit": torch.cuda.mem_get_info(i)[1] / mb}
    return out


def find_max_batch_size(step_fn: Callable[[int], None],
                        start: int = 1, limit: int = 4096) -> int:
    """Double the batch size until step_fn raises torch.OutOfMemoryError;
    return the largest size that succeeded. Any other exception is
    re-raised."""
    best = 0
    b = start
    while b <= limit:
        try:
            step_fn(b)
        except torch.OutOfMemoryError:
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            break
        best = b
        b *= 2
    return best
