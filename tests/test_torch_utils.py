"""The port's tooling against the JAX package's (tests/test_aux.py): the
logging stream redirect, the step timer's report, device memory
statistics, the OOM batch-size probe, a torch.profiler trace, and the
parameter visualizers addressed by JAX tree paths."""

import json
import logging
import os

import numpy as np
import pytest
import torch

import vae_teb_tpu.utils as jax_utils
from vae_teb_tpu_torch import SeqVaeTeb
from vae_teb_tpu_torch.utils import (StepTimer, StreamToLogger,
                                     device_memory_stats, find_max_batch_size,
                                     list_layers, setup_logging, trace,
                                     visualize_layer_parameters,
                                     visualize_weight_overview)

torch.set_num_threads(2)


def test_setup_logging_writes_file(tmp_path):
    log_file = str(tmp_path / "t.log")
    log = setup_logging(log_file, capture_root=False)
    log.info("hello framework")
    for h in log.handlers:
        h.flush()
    assert "hello framework" in open(log_file).read()
    log.handlers.clear()


@pytest.mark.parametrize("cls", [StreamToLogger, jax_utils.StreamToLogger],
                         ids=["port", "jax"])
def test_stream_to_logger(cls):
    """Complete lines go to the logger as they arrive, blank ones are
    dropped, flush writes the partial tail; both packages alike."""
    logger = logging.getLogger(f"test_stream_{cls.__module__}")
    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    s = cls(logger)
    s.write("line one\nline two\n\npartial")
    assert records == ["line one", "line two"]
    s.flush()
    assert records == ["line one", "line two", "partial"]


def test_step_timer_report_matches_jax_format(tmp_path):
    """Sections by total time, calls, totals and means, in the JAX
    package's column layout (the header line identical)."""
    t, j = StepTimer(), jax_utils.StepTimer()
    for timer in (t, j):
        for name in ("alpha", "alpha", "beta"):
            with timer.section(name):
                pass
    rep = t.report()
    assert rep.splitlines()[0] == j.report().splitlines()[0]
    rows = {line.split()[0]: line.split() for line in rep.splitlines()[1:]}
    assert rows["alpha"][1] == "2" and rows["beta"][1] == "1"
    p = str(tmp_path / "prof.txt")
    t.save(p)
    assert open(p).read() == rep + "\n"


def test_device_memory_stats_shape(monkeypatch):
    """A dict per device; on a card the JAX package's MB keys, read from
    torch.cuda.memory_stats / mem_get_info (stubbed here)."""
    stats = device_memory_stats()
    assert isinstance(stats, dict) and len(stats) >= 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": (i + 1) * 2 ** 20,
        "allocated_bytes.all.peak": (i + 2) * 2 ** 20})
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (0, 80 * 2 ** 30))
    stats = device_memory_stats()
    assert stats == {
        "cuda:0": {"mb_in_use": 1.0, "peak_mb_in_use": 2.0,
                   "mb_limit": 81920.0},
        "cuda:1": {"mb_in_use": 2.0, "peak_mb_in_use": 3.0,
                   "mb_limit": 81920.0}}


def test_find_max_batch_size_stops_at_oom_only():
    """Doubling until torch.OutOfMemoryError: the largest size that ran;
    any other exception propagates."""
    def step(limit):
        def fn(b):
            if b > limit:
                raise torch.OutOfMemoryError("CUDA out of memory")
        return fn

    assert find_max_batch_size(step(40)) == 32
    assert find_max_batch_size(step(1000), start=4, limit=64) == 64
    assert find_max_batch_size(step(0)) == 0

    def broken(b):
        raise RuntimeError("out of memory, but not a torch OOM")
    with pytest.raises(RuntimeError):
        find_max_batch_size(broken)


def test_trace_writes_a_chrome_trace(tmp_path):
    """torch.profiler over the region, exported as a Chrome / Perfetto
    trace with the region's operators in it."""
    with trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def _state():
    r = np.random.default_rng(0)
    t = lambda *shape: torch.tensor(r.standard_normal(shape), dtype=torch.float32)
    return {"enc.dense.0.weight": t(4, 8), "enc.dense.0.bias": torch.zeros(4),
            "dec.dense.0.weight": t(8, 4), "dec.dense.0.bias": torch.ones(8),
            "dec.bn.running_mean": torch.zeros(8)}


def test_layer_visualizers(tmp_path):
    """tests/test_aux.py::test_layer_visualizers on a state_dict: paths are
    the JAX tree's, a heatmap for kernels, a histogram for biases (suffix
    match), ambiguous and unknown names raise, the RMS overview."""
    state = _state()
    layers = list_layers(state)
    assert layers == ["dec/Dense_0/bias", "dec/Dense_0/kernel",
                      "enc/Dense_0/bias", "enc/Dense_0/kernel"]
    p1 = str(tmp_path / "kernel.png")
    visualize_layer_parameters(state, "enc/Dense_0/kernel", p1)
    assert os.path.exists(p1)
    p2 = str(tmp_path / "bias.png")
    visualize_layer_parameters(state, "dec/Dense_0/bias", p2)
    assert os.path.exists(p2)
    with pytest.raises(ValueError):
        visualize_layer_parameters(state, "Dense_0/kernel", p1)
    with pytest.raises(ValueError):
        visualize_layer_parameters(state, "nope", p1)
    p3 = str(tmp_path / "overview.png")
    visualize_weight_overview(state, p3)
    assert os.path.exists(p3)


def test_visualizers_address_the_jax_tree_of_a_module():
    """On a module, the paths are those of the JAX model's params tree
    (every parameter, none of the BatchNorm statistics), kernels in flax's
    (in, out) layout; the JAX visualizer lists the same paths from the
    flax tree."""
    import jax
    import jax.numpy as jnp
    from vae_teb_tpu.models import SeqVaeTeb as JaxSeqVaeTeb
    from vae_teb_tpu_torch.utils.visualize import _flatten
    small = dict(lstm_hidden_dim=8, lstm_num_layers=2)
    model = SeqVaeTeb(**small, seq_len=8)
    shapes = jax.eval_shape(lambda: JaxSeqVaeTeb(**small).init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        *[jnp.zeros((1, 8, c)) for c in (43, 44, 130)], train=False))
    want = jax_utils.list_layers(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]))
    assert list_layers(model) == want
    flat = _flatten(model)
    kernel = flat["decoder/linear_0/Dense_0/kernel"]
    np.testing.assert_array_equal(
        kernel, model.decoder.linear_0.dense[0].weight.detach().numpy().T)
