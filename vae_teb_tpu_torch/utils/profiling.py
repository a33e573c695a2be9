"""Profiling and device observability.

Port of `vae_teb_tpu.utils.profiling` on PyTorch:

  trace(log_dir)         torch.profiler trace of a code region, exported
                         as a Chrome / Perfetto trace (trace.json)
  StepTimer              per-section wall times -> the same report format
  device_memory_stats    memory in use per visible CUDA device, in MB
  find_max_batch_size    largest power-of-two batch that fits (OOM probe)

and the port's own spans and stage marks, placed where the work happens
(`serve`, `ops.phase`, `models.vae_teb`, `train.trainer`, `train.graphs`):

  span(name)             a host span `vae_teb.<name>` while a torch.profiler
                         session is active (one flag check otherwise)
  stages(kind, device)   the stage marks of one request or train step
  mark(name)             a timing CUDA event ending stage `name`
  mark_on_grad(t, name)  the same, when t's gradient is ready
  snapshot(), reset()    what was recorded: spans by name, stage times
  records()              the span records themselves

Spans. While a profiler session is active, `span` opens
`record_function("vae_teb.<name>")`, so the span sits on the profiler's
clock over the device operations it launched (a Chrome trace from `trace`
shows it), and keeps a `SpanRecord`: name, host start and end, parent and
id. A span opened under no other takes a new id; the spans inside it
share it, so the spans of one `InferenceServer.infer` call, or of one
`Trainer.train_multi_step` group, have one id. With no session active a
span records nothing.

Stage marks time the device work of a request or a step: a start mark,
then one mark at the end of each stage (CUDA events on the current
stream). A stage's time runs from the mark before it to its own, summed
where one name ends several stretches. In eager code marks are recorded
only while a profiler session is active and the work is on a CUDA
device: a request's stage times are those of profiled requests, and where
the host paces the device (the encoders' launches) the profiler's host
cost stretches them. Under a CUDA graph capture they are always
recorded, as external events: the graph replays them, and
`train.graphs.StepGraph` keeps them, so each replay's stage times can be
read once it has run. The port's stages: a request's `scattering`,
`correlation`, `encode`, `decode`; a step's `encode`, `decode` (the loss
included), `decode_backward` (until z's gradient is ready),
`encode_backward` (the rest of the backward) and `optimizer`. A request's stage times are folded into running sums once
its last mark has run; the requests still running are kept until then.

Spans and marks follow one host thread's requests or steps at a time
(the autograd engine's thread adds the marks of the step it runs).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "vae_teb."


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


# -- spans and stage marks ---------------------------------------------------

_OFF = contextlib.nullcontext()
_ids = itertools.count()
_open: List["SpanRecord"] = []          # the spans open now, innermost last
_records: List["SpanRecord"] = []
_stages: Optional["Stages"] = None      # the request's or step's, while open
_running: List["Stages"] = []           # closed requests, marks maybe pending
_request_ms: Dict[str, float] = defaultdict(float)   # folded, by stage
_request_n: Dict[str, int] = defaultdict(int)
_step: Optional["Stages"] = None        # the latest step's
_captured: Optional["Stages"] = None    # the latest captured step's


class SpanRecord:
    """One span: `name`, host `start` and `end` (time.perf_counter
    seconds), `parent` (the SpanRecord it opened inside, or None), `id`
    (its request's or group's), and `child_s`, the time its children
    cover. Also the context manager `span` returns while profiling."""

    __slots__ = ("name", "start", "end", "parent", "id", "child_s", "_fn")

    def __init__(self, name: str):
        self.name = name
        self.start = self.end = None
        self.child_s = 0.0

    @property
    def duration_s(self) -> float:
        return self.end - self.start

    @property
    def self_s(self) -> float:
        """The duration less what the children cover."""
        return self.duration_s - self.child_s

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        self.id = self.parent.id if self.parent else next(_ids)
        self._fn = _autograd_profiler.record_function(PREFIX + self.name)
        self._fn.__enter__()
        _open.append(self)
        _records.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        _open.pop()
        self._fn.__exit__(*exc)
        if self.parent is not None:
            self.parent.child_s += self.duration_s
        return False


def span(name: str):
    """A context manager timing `name` (see the module docstring): a
    `SpanRecord` while a profiler session is active, else a no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return SpanRecord(name)


class Stages:
    """The marks of one request or step (`kind`): (name, CUDA event) in
    the order recorded, the first named "start"; `captured` when they were
    recorded into a CUDA graph. Opened by `stages`."""

    def __init__(self, kind: str, captured: bool):
        self.kind, self.captured = kind, captured
        self.marks: List[tuple] = []

    def add(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True, external=self.captured)
        ev.record()
        self.marks.append((name, ev))

    def ms(self) -> Dict[str, float]:
        """Each stage's device milliseconds in the latest run of these
        marks (waits for it to finish)."""
        self.marks[-1][1].synchronize()
        out: Dict[str, float] = {}
        for (_, before), (name, ev) in zip(self.marks, self.marks[1:]):
            out[name] = out.get(name, 0.0) + before.elapsed_time(ev)
        return out

    def __enter__(self):
        global _stages
        _stages = self
        self.add("start")
        return self

    def __exit__(self, exc_type, *exc):
        global _stages, _step, _captured
        _stages = None
        if exc_type is not None:
            return False
        if self.captured:
            _captured = self
        elif self.kind == "step":
            _step = self
        else:
            _fold_requests(wait=False)
            _running.append(self)
        return False


def _fold_requests(wait: bool) -> None:
    """Add the stage times of the closed requests whose last mark has run
    (all of them, waiting, if `wait`) to the running sums."""
    still = []
    for s in _running:
        if wait or s.marks[-1][1].query():
            for name, ms in s.ms().items():
                _request_ms[name] += ms
                _request_n[name] += 1
        else:
            still.append(s)
    _running[:] = still


def stages(kind: str, device: torch.device):
    """A context manager holding the stage marks of one request or step
    (`kind` "request" or "step") on `device`, with a start mark where it
    opens: `Stages` under a CUDA graph capture, or in eager work while a
    profiler session is active; a no-op on the CPU or otherwise. Closed,
    eager stages become a request's record or the latest step's; captured
    ones are handed to the capture (`captured_stages`)."""
    if device.type != "cuda":
        return _OFF
    if torch.cuda.is_current_stream_capturing():
        return Stages(kind, captured=True)
    if _autograd_profiler._is_profiler_enabled:
        return Stages(kind, captured=False)
    return _OFF


def mark(name: str) -> None:
    """End the stage `name` of the open request or step, if any."""
    if _stages is not None:
        _stages.add(name)


def mark_on_grad(tensor: torch.Tensor, name: str) -> None:
    """End the stage `name` of the open step when `tensor`'s gradient is
    ready (a tensor hook; the gradient passes unchanged)."""
    open_ = _stages
    if open_ is not None and tensor.requires_grad:
        tensor.register_hook(lambda grad: open_.add(name))


def captured_stages() -> Optional[Stages]:
    """The stages of the step captured last, handed over once."""
    global _captured
    out, _captured = _captured, None
    return out


def replayed(step_stages: Optional[Stages]) -> None:
    """A captured step whose marks are `step_stages` was replayed: its
    marks are the latest step's."""
    global _step
    if step_stages is not None:
        _step = step_stages


def records() -> List[SpanRecord]:
    """The spans closed since the last `reset`, in the order opened."""
    return [r for r in _records if r.end is not None]


def snapshot() -> Dict:
    """What was recorded since the last `reset`:

    spans:  {name: {"calls", "host_s", "self_s"}}, host seconds summed
    stages: {"request": {stage: mean ms over the requests recorded},
             "step": {stage: ms in the latest replay, or the latest
                      profiled eager step}}
    Reading the stage times waits for their last mark."""
    spans: Dict[str, Dict] = {}
    for r in records():
        e = spans.setdefault(r.name, {"calls": 0, "host_s": 0.0,
                                      "self_s": 0.0})
        e["calls"] += 1
        e["host_s"] += r.duration_s
        e["self_s"] += r.self_s
    _fold_requests(wait=True)
    request = {name: ms / _request_n[name] for name, ms in _request_ms.items()}
    return {"spans": spans,
            "stages": {"request": request,
                       "step": _step.ms() if _step is not None else {}}}


def reset() -> None:
    """Forget the spans and stage marks recorded so far."""
    global _step
    _records.clear()
    _running.clear()
    _request_ms.clear()
    _request_n.clear()
    _step = None
