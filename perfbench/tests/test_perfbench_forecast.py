"""The forecaster's cell (`train.seqvae_teb_forecast.b128`) at a small size
on the CPU where sliding windows are kept (the small frontend's 68 steps,
horizon 32, warmup 4): the cell end to end, traced and not; its counts
against PyTorch's own count of the reference's training step; the
control one precision down and the half-batch fault each failing a
limit; and its stage readers on synthetic snapshots."""

import copy
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT, TRAIN_SMALL, TRAIN_TRAFFIC

from perfbench import weights
from perfbench.control_forecast import control
from perfbench.counts import HBM_BYTES_PER_S, PEAK_FLOPS
from perfbench.counts_forecast import forward_flops, grid_least_s, step_flops
from perfbench.reference.forecast import (ForecastModel, forecast_loss,
                                          param_shapes)
from perfbench.reference.model import is_buffer
from perfbench.run import _load, run_cell

CELL = "train.seqvae_teb_forecast.b128"
KEPT = copy.deepcopy(TRAIN_SMALL)
KEPT["model"].update(prediction_horizon=32, warmup_period=4)
NEW = ("step_device_ms.forecast", "step_mfu.forecast",
       "window_decoder_ms.forecast", "encoder_ms.forecast",
       "grid_roofline.forecast", "device_idle.forecast")

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
with open(os.path.join(ROOT, "perfbench", "configs",
                       "seqvae_teb_forecast.json")) as f:
    CONFIG = json.load(f)
with open(os.path.join(ROOT, "perfbench", "limits", CELL + ".json")) as f:
    LIMITS = json.load(f)


def test_entries():
    """One configuration, one cell on one chip, its name appended to
    `train_windows_per_s`, and six per-layer metrics listing it alone."""
    (cell,) = [w for w in BENCH["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "seqvae_teb_forecast", "train_forecast_b128", 1)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["train_windows_per_s"]["workloads"][-1] == CELL
    listed = {m["name"]: m for m in BENCH["per_layer"]
              if CELL in m.get("workloads", [])}
    assert sorted(listed) == sorted(NEW)
    assert all(m["workloads"] == [CELL] for m in listed.values())
    assert CONFIG["model"]["prediction_horizon"] == 480
    assert CONFIG["model"]["hidden"] == 256


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_small_with_windows_kept(trace):
    """The cell end to end at the small size, windows kept at t = 4 .. 64:
    no step fails, the program's first loss is the float64 reference's to
    float32 rounding, and the line holds the cell's end-to-end metrics
    (untraced) or the new per-layer metrics that need no card (traced:
    the stage marks and the device trace record nothing on the CPU)."""
    result, numbers = run_cell(CELL, 2 ** 31 + 4321, 3.0, bool(trace),
                               device="cpu", config_overrides=KEPT,
                               traffic_overrides=TRAIN_TRAFFIC)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert numbers["loss_gap.step1"] < 1e-5
    assert set(result["checks"]) == set(LIMITS)
    assert result["correct"] == all(c["value"] <= c["limit"]
                                    for c in result["checks"].values())
    if not trace:
        assert sorted(result["metrics"]) == ["setup_s", "train_windows_per_s"]
    else:
        assert set(result["metrics"]) == {"step_mfu.forecast"}


def test_flops_match_flop_counter():
    """Forward and backward of the reference's training step at a small
    size: 3x the analytic forward, but that the first step's recurrent
    product of each LSTM layer has no input gradient (its state is the
    zero start)."""
    cfg = dict(CONFIG["model"], lstm_hidden_dim=8, lstm_num_layers=2,
               seq_len=12, hidden=16, prediction_horizon=24, warmup_period=2)
    B, S = 2, cfg["seq_len"]
    made = weights.make(param_shapes(cfg), 3, "cpu", torch.float64)
    P = {n: v.requires_grad_(not is_buffer(n)) for n, v in made.items()}
    g = torch.Generator().manual_seed(3)
    fields = [torch.randn((B, S, c), generator=g, dtype=torch.float64)
              for c in (cfg["n_scattering"], cfg["n_phase"],
                        cfg["input_channels"])]
    y_raw = torch.randn((B, S * cfg["decimation_factor"]), generator=g,
                        dtype=torch.float64)
    eps = torch.randn((B, S, cfg["latent_dim"]), generator=g,
                      dtype=torch.float64)
    counter = FlopCounterMode(display=False)
    with counter:
        out = ForecastModel(cfg, P).forward(*fields, eps)
        forecast_loss(out, y_raw, 1e-5, 2, 16)["total_loss"].backward()
    f = forward_flops(cfg)
    rec_step = f["lstm_recurrent"] / S
    want = 3 * B * (f["dense"] + f["conv"] + f["lstm_input"]) + \
        B * (3 * S - 1) * rec_step
    assert counter.get_total_flops() == pytest.approx(want, rel=1e-12)
    assert step_flops(cfg, B) == pytest.approx(3 * B * sum(f.values()))


def test_counts_at_the_published_shape():
    """5.52 GFLOP a window forward, 2.12 TFLOP a B=128 step; the decoder
    LSTM's least time is its operations at the float32 peak both ways
    (compute-bound: its bytes take a fifth of that)."""
    cfg = dict(CONFIG["model"], precision="fp32")
    assert sum(forward_flops(cfg).values()) == pytest.approx(5.517e9,
                                                             rel=1e-3)
    assert step_flops(cfg, 128) == pytest.approx(2.1185e12, rel=1e-3)
    ops = 5 * 2 * 256 * 1024 * 128 * 300
    assert grid_least_s(cfg, 128) == pytest.approx(2 * ops / PEAK_FLOPS[
        "fp32"])
    assert 4 * 128 * 300 * 1024 * 4 / HBM_BYTES_PER_S < ops / PEAK_FLOPS[
        "fp32"]


@pytest.mark.parametrize("precision,fault", [("tf32", None),
                                             (None, "half_batch")])
def test_control_and_fault_fail_a_limit(precision, fault):
    """The reference one precision down, and a step whose loss takes half
    the rows, each read above one of the cell's limits."""
    numbers = control(CELL, 21, precision, fault, device="cpu",
                      config_overrides=KEPT,
                      traffic_overrides=TRAIN_TRAFFIC)
    assert [k for k, lim in LIMITS.items() if not numbers[k] <= lim], numbers


def _reader(name):
    return _load(os.path.join(ROOT, "perfbench", "metrics", name + ".py"),
                 "perfbench.metrics." + name.replace(".", "_"))


STAGES = {"encode": 10.0, "window_paths": 20.0, "window_heads": 15.0,
          "decode": 5.0, "decode_backward": 40.0, "encode_backward": 14.0,
          "optimizer": 3.0}


@pytest.mark.parametrize("name,want", [("window_decoder_ms.forecast", 80.0),
                                       ("encoder_ms.forecast", 24.0)])
def test_stage_readers(name, want, monkeypatch):
    """From a synthetic snapshot: the decoder's four stages, the encoders'
    two; None in a cell of the other driver (no `grid_least_s`), without
    the stages, and with a program that has no `snapshot`."""
    from vae_teb_tpu_torch.utils import profiling
    reader = _reader(name)
    readings = {"kind": "train", "K": 8, "grid_least_s": 1e-3}
    monkeypatch.setattr(profiling, "snapshot", lambda: {
        "spans": {}, "stages": {"request": {}, "step": STAGES}})
    assert reader.read(readings) == pytest.approx(want)
    assert reader.read({"kind": "train", "K": 8}) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: {
        "spans": {}, "stages": {"request": {}, "step": {}}})
    assert reader.read(readings) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert reader.read(readings) is None


def test_trace_readers():
    """The device-trace readers from synthetic readings: the grid kernels'
    share of their least time, the idle share, the step's device time and
    its share of the peak; None where the trace holds nothing."""
    tr = {"busy_s": 0.9, "window_s": 1.0, "units": 16,
          "kernels": {"wavefront_grid_fwd_kernel": 0.1,
                      "wavefront_grid_bwd_kernel": 0.3,
                      "wavefront_fwd_kernel": 5.0}}
    r = {"kind": "train", "K": 8, "steps": 80, "window_s": 10.0,
         "group_ms": [800.0, 820.0], "flops_per_step": 2e12,
         "peak_flops": 165e12, "grid_least_s": 1e-3, "trace": tr}
    assert _reader("grid_roofline.forecast").read(r) == pytest.approx(4.0)
    assert _reader("device_idle.forecast").read(r) == pytest.approx(10.0)
    assert _reader("step_device_ms.forecast").read(r) == pytest.approx(101.25)
    assert _reader("step_mfu.forecast").read(r) == pytest.approx(
        100 * 2e12 * 8 / 165e12)
    empty = dict(r, trace={}, group_ms=[])
    for name in ("grid_roofline.forecast", "device_idle.forecast",
                 "step_device_ms.forecast"):
        assert _reader(name).read(empty) is None
