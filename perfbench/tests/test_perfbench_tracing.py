"""The readers of the program's own spans and stage marks
(`vae_teb_tpu_torch.utils.profiling.snapshot()`): None where the program
has no `snapshot` (an older program) or the stage or span is absent; the
expected value from a synthetic snapshot; and the span readers non-null
in a traced run of each cell at the small size on the CPU, where the
stage marks (CUDA events) record nothing."""

import json
import os

import pytest

from conftest import ROOT, small

from perfbench.run import _load, run_cell

READERS = {  # name: the kind of cell it reads
    "encoder_ms.train": "train", "decoder_ms.train": "train",
    "optimizer_ms.train": "train", "enqueue_ms.train": "train",
    "scattering_ms.serve": "serve", "correlation_ms.serve": "serve",
    "encoder_ms.serve": "serve", "decoder_ms.serve": "serve",
    "enqueue_ms.serve": "serve"}
SNAPSHOT = {
    "spans": {"trainer.train_multi_step": {"calls": 2, "host_s": 0.016,
                                           "self_s": 0.004},
              "graph.launch": {"calls": 16, "host_s": 0.008,
                               "self_s": 0.008},
              "serve.infer": {"calls": 8, "host_s": 0.24, "self_s": 0.08}},
    "stages": {"request": {"scattering": 4.5, "correlation": 8.25,
                           "encode": 9.0, "decode": 21.5},
               "step": {"encode": 10.0, "decode": 30.0,
                        "decode_backward": 22.0, "encode_backward": 14.0,
                        "optimizer": 6.5}}}
EXPECTED = {"encoder_ms.train": 24.0, "decoder_ms.train": 52.0,
            "optimizer_ms.train": 6.5, "enqueue_ms.train": 0.5,
            "scattering_ms.serve": 4.5, "correlation_ms.serve": 8.25,
            "encoder_ms.serve": 9.0, "decoder_ms.serve": 21.5,
            "enqueue_ms.serve": 30.0}
K = 8

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


def _reader(name):
    return _load(os.path.join(ROOT, "perfbench", "metrics", name + ".py"),
                 "perfbench.metrics." + name.replace(".", "_"))


def _readings(kind):
    return {"kind": kind, "K": K}


def test_entries_name_one_cell_of_their_kind():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name, kind in READERS.items():
        (cell,) = entries[name]["workloads"]
        assert cell.startswith(kind + ".")


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_returns_none_without_snapshot(name, monkeypatch):
    """An older program's profiling module, with no `snapshot`."""
    from vae_teb_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "snapshot")
    assert _reader(name).read(_readings(READERS[name])) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_from_a_synthetic_snapshot(name, monkeypatch):
    """The expected value; None in the other kind of cell and where the
    snapshot holds nothing."""
    from vae_teb_tpu_torch.utils import profiling
    reader = _reader(name)
    kind = READERS[name]
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAPSHOT)
    assert reader.read(_readings(kind)) == pytest.approx(EXPECTED[name])
    other = "serve" if kind == "train" else "train"
    assert reader.read(_readings(other)) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: {
        "spans": {}, "stages": {"request": {}, "step": {}}})
    assert reader.read(_readings(kind)) is None


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_span_readers_read_a_traced_cpu_run(workload):
    """A traced run of the cell at the small size on the CPU: its
    `enqueue_ms` reader reads the program's span, over the traced groups'
    steps or requests; the stage readers find no marks on the CPU and the
    line leaves them out."""
    from vae_teb_tpu_torch.utils import profiling
    profiling.reset()
    cfg, traffic = small(workload)
    result, _ = run_cell(workload, 2 ** 31 + 777, 3.0, True, device="cpu",
                         config_overrides=cfg, traffic_overrides=traffic)
    kind = workload.split(".")[0]
    spans = profiling.snapshot()["spans"]
    name = "enqueue_ms." + kind
    assert result["metrics"][name]["value"] > 0
    if kind == "train":     # fewer where the window closed first
        assert 1 <= spans["trainer.train_multi_step"]["calls"] <= \
            traffic["trace_groups"]
    else:
        assert 1 <= spans["serve.infer"]["calls"] <= \
            traffic["trace_requests"]
    marked = {n for n, k in READERS.items() if k == kind} - {name}
    assert not marked & set(result["metrics"])
    profiling.reset()
