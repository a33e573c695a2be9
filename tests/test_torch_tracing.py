"""The port's spans and stage marks (`vae_teb_tpu_torch.utils.profiling`).

On the CPU, at a small size: with no profiler session the serving request
and a K=2 `Trainer.train_multi_step` record nothing and open no
`record_function`; under `torch.profiler` every span of the serving and
training paths appears with its parent, its request's or group's id and a
self time within its duration, also as a `vae_teb.*` event of the
profile; `snapshot` and `reset`. The stage marks are CUDA events, so on
the CPU they are held with a stand-in clock; the `cuda` cases hold them
on the card against CUDA events around a replay and around a request.
This file imports no JAX, so it runs on the card too:
`python -m pytest tests/test_torch_tracing.py -m cuda`.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vae_teb_tpu_torch import (InferenceServer, PhaseScattering1D, SeqVaeTeb,
                               Trainer, TrainerConfig, init_parameters)
from vae_teb_tpu_torch.utils import profiling

torch.set_num_threads(2)

S, B = 8, 3
FIELDS = ("fhr_st", "fhr_ph", "fhr_up_ph", "fhr")
# J=6, Q=2, T=8 over 1024 samples: 14 scattering, 24 phase and 24 cross
# channels, 68 steps kept, 8 raw samples a step
SMALL_SERVE = dict(input_channels=24, n_scattering=14, n_phase=24,
                   lstm_hidden_dim=8, lstm_num_layers=2, seq_len=68,
                   decimation_factor=8)
SERVE_SPANS = {"serve.infer": None, "serve.coefficients": "serve.infer",
               "frontend.analyze": "serve.coefficients",
               "model.encode": "serve.infer", "model.decode": "serve.infer"}
# the emulated replays run the step body on the host, so the model's spans
# sit under them too
TRAIN_SPANS = {"trainer.train_multi_step": None,
               "trainer.eager_step": "trainer.train_multi_step",
               "trainer.capture": "trainer.train_multi_step",
               "trainer.replay": "trainer.train_multi_step",
               "model.encode": ("trainer.eager_step", "trainer.replay"),
               "model.decode": ("trainer.eager_step", "trainer.replay")}


@pytest.fixture(autouse=True)
def _clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _stack(seed, k=2):
    return {"fhr_st": _x((k, B, S, 43), seed), "fhr_ph": _x((k, B, S, 44),
                                                            seed + 1),
            "fhr_up_ph": _x((k, B, S, 130), seed + 2),
            "fhr": _x((k, B, 16 * S), seed + 3)}


def _server():
    model = init_parameters(SeqVaeTeb(**SMALL_SERVE), seed=1)
    return InferenceServer(model, PhaseScattering1D(
        J=6, Q=2, T=8, shape=1024, max_order=1, reduced_rate=True,
        device="cpu"), "cpu")


class _HostGraph:
    """A captured step emulated on the CPU (as in test_torch_capture.py):
    capturing runs nothing, a replay runs the step body on the row."""

    def __init__(self, step, shapes):
        self.step, self.shapes = step, shapes
        self.launches, self.replays = Counter(), 0

    def replay(self, row):
        sizes = [int(np.prod(s)) for s in self.shapes]
        views = [v.view(s) for v, s in zip(row.split(sizes), self.shapes)]
        metrics = self.step(*views, *[None] * (5 - len(views)))
        self.metrics = tuple(metrics)
        return torch.stack([metrics[k].float() for k in metrics])


def _trainer(monkeypatch):
    """A small CPU trainer whose K-step groups take the capture path, with
    each graph emulated on the host: the first group runs eagerly and
    captures, the next replays."""
    import vae_teb_tpu_torch.train.trainer as trainer_module
    monkeypatch.setattr(trainer_module, "capture_step",
                        lambda step, shapes, *_: _HostGraph(step, shapes))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    model = init_parameters(SeqVaeTeb(lstm_hidden_dim=8, lstm_num_layers=2,
                                      seq_len=S), seed=1)
    trainer = Trainer(model, TrainerConfig(steps_per_execution=2, lr=1e-3),
                      device="cpu")
    trainer.captures = True
    return trainer


def _no_record_function(monkeypatch):
    """Refuse a `record_function` of the port's (torch.optim opens its own
    whatever the profiler)."""
    original = profiling._autograd_profiler.record_function

    def refuse(name, *args, **kwargs):
        assert not name.startswith(profiling.PREFIX), name
        return original(name, *args, **kwargs)
    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        refuse)


def test_nothing_is_recorded_without_a_profiler(monkeypatch):
    """No profiler session: a request, a K=2 group on the CPU's loop and
    two groups on the (emulated) capture path open no record_function and
    leave the registry empty; the spans are one shared no-op."""
    _no_record_function(monkeypatch)
    server = _server()
    x = _x((2, 2, 1024), 0)
    server.infer(x[0], x[1])
    cpu = Trainer(init_parameters(SeqVaeTeb(lstm_hidden_dim=8,
                                            lstm_num_layers=2, seq_len=S),
                                  seed=1),
                  TrainerConfig(steps_per_execution=2), device="cpu")
    cpu.train_multi_step(_stack(10), 1e-5)
    trainer = _trainer(monkeypatch)
    trainer.train_multi_step(_stack(20), 1e-5)
    trainer.train_multi_step(_stack(30), 1e-5)
    assert profiling.records() == []
    assert profiling.snapshot() == {"spans": {}, "stages": {"request": {},
                                                            "step": {}}}
    assert profiling.span("a") is profiling.span("b")
    assert profiling.stages("step", torch.device("cpu")) is \
        profiling.span("a")


def _check_tree(recs, parents):
    """Every span has its name's parent (or one of them) and its root's
    id, and a self time within its duration."""
    for r in recs:
        want = parents[r.name]
        got = r.parent.name if r.parent else None
        assert got in want if isinstance(want, tuple) else got == want, \
            r.name
        root = r
        while root.parent is not None:
            root = root.parent
        assert r.id == root.id
        assert r.end >= r.start
        assert 0.0 <= r.self_s <= r.duration_s + 1e-9
        assert r.child_s == pytest.approx(sum(
            c.duration_s for c in recs if c.parent is r), abs=1e-9)


def test_profiled_request_gives_its_spans():
    """Two requests under torch.profiler: each gives the five serving
    spans, nested as the request runs them, under one id a request."""
    server = _server()
    x = _x((2, 2, 1024), 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        server.infer(x[0], x[1])
        server.infer(x[0], x[1])
    recs = profiling.records()
    assert Counter(r.name for r in recs) == Counter(
        {name: 2 for name in SERVE_SPANS})
    _check_tree(recs, SERVE_SPANS)
    roots = [r for r in recs if r.parent is None]
    assert len({r.id for r in roots}) == 2
    names = Counter(e.name for e in prof.events()
                    if e.name.startswith(profiling.PREFIX))
    assert names == Counter({profiling.PREFIX + n: 2 for n in SERVE_SPANS})


def test_profiled_groups_give_their_spans(monkeypatch):
    """Two K=2 groups on the capture path (graphs emulated on the host)
    under torch.profiler: the first runs two eager steps and captures,
    the second replays twice; each group's spans share its id."""
    trainer = _trainer(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_multi_step(_stack(40), 1e-5)
        trainer.train_multi_step(_stack(50), 1e-5)
    recs = profiling.records()
    counts = Counter(r.name for r in recs)
    assert counts["trainer.train_multi_step"] == 2
    assert counts["trainer.eager_step"] == 2
    assert counts["trainer.capture"] == 1
    assert counts["trainer.replay"] == 2
    _check_tree(recs, TRAIN_SPANS)
    groups = [r for r in recs if r.name == "trainer.train_multi_step"]
    assert groups[0].id != groups[1].id
    first = {r.name for r in recs if r.id == groups[0].id}
    second = {r.name for r in recs if r.id == groups[1].id}
    assert {"trainer.eager_step", "trainer.capture"} <= first
    assert "trainer.replay" not in first
    assert "trainer.replay" in second and "trainer.eager_step" not in second
    names = {e.name for e in prof.events()}
    assert {profiling.PREFIX + n for n in TRAIN_SPANS} <= names


def test_graph_launch_span_sits_in_the_replay():
    """`StepGraph.replay` opens `graph.launch` around the launch alone,
    inside the trainer's `trainer.replay`, under a profiler session only."""
    from vae_teb_tpu_torch.train.graphs import StepGraph

    class Graph:
        def replay(self):
            out.copy_(inputs[:2] * 2)

    inputs, out = torch.zeros(4), torch.zeros(2)
    graph = StepGraph(Graph(), inputs, out, ["a", "b"], Counter())
    assert torch.equal(graph.replay(torch.ones(4)), torch.full((2,), 2.0))
    assert profiling.records() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("trainer.replay"):
            graph.replay(torch.arange(4.0))
    replay, launch = profiling.records()
    assert (replay.name, launch.name) == ("trainer.replay", "graph.launch")
    assert launch.parent is replay and launch.id == replay.id
    assert replay.start <= launch.start <= launch.end <= replay.end
    assert torch.equal(out, torch.tensor([0.0, 2.0]))
    assert profiling.PREFIX + "graph.launch" in {e.name for e in prof.events()}


def test_snapshot_sums_spans_and_reset_clears():
    """snapshot()["spans"]: calls, host seconds and self seconds by name,
    the sums of the records; reset() forgets them."""
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    torch.ones(64).sum()
    snap = profiling.snapshot()["spans"]
    recs = profiling.records()
    for name in ("outer", "inner"):
        mine = [r for r in recs if r.name == name]
        assert snap[name]["calls"] == 3
        assert snap[name]["host_s"] == pytest.approx(
            sum(r.duration_s for r in mine))
        assert snap[name]["self_s"] == pytest.approx(
            sum(r.self_s for r in mine))
    assert snap["inner"]["self_s"] == pytest.approx(snap["inner"]["host_s"])
    assert snap["outer"]["self_s"] == pytest.approx(
        snap["outer"]["host_s"] - snap["inner"]["host_s"])
    profiling.reset()
    assert profiling.records() == []
    assert profiling.snapshot()["spans"] == {}


class _Clock:
    """Stand-in CUDA events: each mark reads a clock the test moves."""

    def __init__(self):
        self.now = 0.0

    def event(self):
        clock = self

        class Event:
            t = clock.now

            def synchronize(self):
                pass

            def query(self):
                return True

            def elapsed_time(self, other):
                return other.t - self.t
        return Event()


def test_stage_marks_sum_into_stages(monkeypatch):
    """A stage runs from the mark before it to its own, summed where one
    name ends several stretches; requests average, the step is the latest
    one (an eager step's or a replay's); marks outside an open request or
    step, and stages on the CPU, record nothing."""
    clock = _Clock()
    monkeypatch.setattr(profiling.Stages, "add", lambda self, name:
                        self.marks.append((name, clock.event())))

    def run(kind, stretches, captured=False):
        with profiling.Stages(kind, captured) as st:
            for name, ms in stretches:
                clock.now += ms
                profiling.mark(name)
        return st

    profiling.mark("encode")                       # nothing is open
    with profiling.stages("request", torch.device("cpu")):
        profiling.mark("encode")
    run("request", [("scattering", 3.0), ("correlation", 8.0),
                    ("encode", 6.0), ("decode", 20.0)])
    run("request", [("scattering", 5.0), ("correlation", 6.0),
                    ("encode", 8.0), ("decode", 22.0)])
    # the first request is folded when the second closes; the second waits
    # for a snapshot
    assert len(profiling._running) == 1
    assert profiling._request_n == {"scattering": 1, "correlation": 1,
                                    "encode": 1, "decode": 1}
    run("step", [("encode", 1.0), ("decode", 2.0), ("decode", 0.5),
                 ("decode_backward", 4.0), ("encode_backward", 3.0),
                 ("optimizer", 1.5)])
    stages = profiling.snapshot()["stages"]
    assert profiling._running == []
    assert stages["request"] == pytest.approx(
        {"scattering": 4.0, "correlation": 7.0, "encode": 7.0,
         "decode": 21.0})
    assert stages["step"] == pytest.approx(
        {"encode": 1.0, "decode": 2.5, "decode_backward": 4.0,
         "encode_backward": 3.0, "optimizer": 1.5})
    captured = run("step", [("encode", 9.0), ("optimizer", 1.0)],
                   captured=True)
    assert profiling.snapshot()["stages"]["step"]["encode"] == 1.0
    assert profiling.captured_stages() is captured
    assert profiling.captured_stages() is None
    profiling.replayed(captured)
    assert profiling.snapshot()["stages"]["step"] == pytest.approx(
        {"encode": 9.0, "optimizer": 1.0})
    profiling.reset()
    assert profiling.snapshot()["stages"] == {"request": {}, "step": {}}


def test_decode_backward_marks_when_z_has_its_gradient(monkeypatch):
    """The mark on z's gradient comes after the loss's mark and before the
    end of the backward, and leaves the gradients unchanged."""
    order = []
    monkeypatch.setattr(profiling.Stages, "add", lambda self, name:
                        order.append(name))

    def grads(marked):
        model = init_parameters(SeqVaeTeb(lstm_hidden_dim=8,
                                          lstm_num_layers=2, seq_len=S),
                                seed=1)
        trainer = Trainer(model, TrainerConfig(lr=1e-3), device="cpu")
        batch = {k: v[0] for k, v in _stack(60, 1).items()}
        eps = torch.as_tensor(_x((B, S, 32), 70))
        if marked:
            monkeypatch.setattr(profiling, "stages",
                                lambda kind, device: profiling.Stages(
                                    kind, False))
        trainer.train_step(batch, 1e-5, eps)
        return [p.detach().clone() for p in model.parameters()]

    plain = grads(False)
    assert order == []
    marked = grads(True)
    assert order == ["start", "encode", "decode", "decode",
                     "decode_backward", "encode_backward", "optimizer"]
    for a, b in zip(plain, marked):
        assert torch.equal(a, b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _elapsed(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


@pytest.mark.cuda
def test_captured_step_marks_sum_to_a_replay(cuda_device):
    """The published model's step at B=32, captured: after one replay with
    no profiler, the stage times of its marks sum to within 5% of CUDA
    events around that replay, every stage of the step is there, and a
    replay records them again."""
    torch.backends.cudnn.allow_tf32 = False
    model = init_parameters(SeqVaeTeb(), seed=1)
    trainer = Trainer(model, TrainerConfig(steps_per_execution=2, lr=1e-3),
                      device=cuda_device)
    rng = np.random.default_rng(0)
    stack = {"fhr_st": rng.standard_normal((2, 32, 300, 43)),
             "fhr_ph": rng.standard_normal((2, 32, 300, 44)),
             "fhr_up_ph": rng.standard_normal((2, 32, 300, 130)),
             "fhr": rng.standard_normal((2, 32, 4800))}
    trainer.train_multi_step(stack, 1e-5)          # eager, then captured
    trainer.train_multi_step(stack, 1e-5)          # replays
    (graph,) = trainer.graphs.values()
    assert [n for n, _ in graph.stages.marks] == [
        "start", "encode", "decode", "decode", "decode_backward",
        "encode_backward", "optimizer"]
    row = torch.cat([torch.as_tensor(stack[k][0], dtype=torch.float32,
                                     device=cuda_device).reshape(-1)
                     for k in FIELDS])
    for _ in range(2):
        profiling.reset()
        _, whole = _elapsed(lambda: graph.replay(row))
        step = profiling.snapshot()["stages"]["step"]
        assert set(step) == {"encode", "decode", "decode_backward",
                             "encode_backward", "optimizer"}
        assert all(v > 0 for v in step.values())
        assert sum(step.values()) == pytest.approx(whole, rel=0.05)


@pytest.mark.cuda
def test_request_marks_sum_to_a_request(cuda_device):
    """The production frontend and the published model at B=32: under a
    profiler session the request's four stages sum to within 5% of CUDA
    events around `infer`, each request counts once in each stage's
    mean, and with no session a request adds nothing."""
    from vae_teb_tpu_torch import production_frontend
    torch.backends.cudnn.allow_tf32 = False
    server = InferenceServer(init_parameters(SeqVaeTeb(), seed=1),
                             production_frontend(cuda_device), cuda_device)
    x = _x((2, 32, 5760), 2)
    server.infer(x[0], x[1])
    torch.cuda.synchronize()
    wholes = []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            _, whole = _elapsed(lambda: server.infer(x[0], x[1]))
            wholes.append(whole)
    request = profiling.snapshot()["stages"]["request"]
    assert set(request) == {"scattering", "correlation", "encode", "decode"}
    assert profiling._request_n == {name: 3 for name in request}
    assert sum(request.values()) == pytest.approx(np.mean(wholes), rel=0.05)
    server.infer(x[0], x[1])
    assert profiling._running == []
    assert profiling._request_n == {name: 3 for name in request}
