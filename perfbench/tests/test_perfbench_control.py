"""The comparison that decides `correct` has to fail: the control (the
reference in the precision below the configuration's, in the program's
place) reads above one of each cell's limits, and a run whose timed path
is broken underneath fails a number that the same run, sound, passes. At
a small size on the CPU;
the `cuda` case reads the controls on the card."""

import json
import os

import pytest
import torch

from conftest import ROOT, small

from perfbench.control import control
from perfbench.run import run_cell

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


def _config(workload):
    cell = next(w for w in BENCH["workloads"] if w["name"] == workload)
    with open(os.path.join(ROOT, "perfbench", "configs",
                           cell["config"] + ".json")) as f:
        return json.load(f)


def _limits(workload):
    with open(os.path.join(ROOT, "perfbench", "limits",
                           workload + ".json")) as f:
        return json.load(f)


def _lower(workload):
    return {"fp32": "tf32", "bf16": "fp8"}[_config(workload)["precision"]]


def _fails(numbers, workload):
    return [k for k, lim in _limits(workload).items() if not
            numbers[k] <= lim]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(workload):
    cfg, traffic = small(workload)
    numbers = control(workload, 21, _lower(workload), device="cpu",
                      config_overrides=cfg, traffic_overrides=traffic)
    assert _fails(numbers, workload), numbers


def _run(workload):
    cfg, traffic = small(workload)
    result, _ = run_cell(workload, 23, 3.0, False, device="cpu",
                         config_overrides=cfg, traffic_overrides=traffic)
    return {k for k, c in result["checks"].items()
            if not c["value"] <= c["limit"]}


def _caught(monkeypatch, workload, name, obj, fault):
    """The numbers the fault fails that the same run, sound, passes."""
    sound = _run(workload)
    monkeypatch.setattr(obj, name, fault)
    return _run(workload) - sound


@pytest.mark.parametrize("what", ["nothing_written", "parameters_unwritten"])
def test_step_that_leaves_the_state_unchanged(monkeypatch, what):
    """The optimizer's step writes nothing, or moves its moments and count
    as a sound step does but leaves the parameters as they were."""
    from vae_teb_tpu_torch.train.schedules import ClippedAdamW
    step = ClippedAdamW.step

    def unchanged(self, closure=None):
        params = [p for p in self.param_groups[0]["params"]
                  if p.grad is not None]
        if what == "nothing_written":
            for p in params:
                self.state[p].setdefault("mu", torch.zeros_like(p))
                self.state[p].setdefault("nu", torch.zeros_like(p))
            return self.grad_norm(params, [p.grad for p in params])
        before = [p.detach().clone() for p in params]
        norm = step(self)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        return norm

    assert _caught(monkeypatch, "train.seqvae_teb.b128", "step",
                   ClippedAdamW, unchanged)


def test_half_of_the_batch_left_out(monkeypatch):
    from vae_teb_tpu_torch.train.trainer import Trainer
    step = Trainer._step

    def half(self, y_st, y_ph, x_ph, y_raw, eps=None):
        n = y_st.shape[0] // 2
        return step(self, y_st[:n], y_ph[:n], x_ph[:n], y_raw[:n],
                    None if eps is None else eps[:n])

    assert _caught(monkeypatch, "train.seqvae_teb.b128", "_step", Trainer,
                   half)


@pytest.mark.parametrize("where", ["output", "coefficients", "cross_pair"])
def test_answer_altered_where_produced(monkeypatch, where):
    from vae_teb_tpu_torch import InferenceServer
    name = "infer" if where == "output" else "coefficients"
    original = getattr(InferenceServer, name)

    def altered(self, fhr, up):
        out = original(self, fhr, up)
        if where == "output":
            mu = out["mu_pr"].clone()
            mu[0] = -mu[0]                    # one window's answer
            out = dict(out, mu_pr=mu)
        elif where == "coefficients":
            out = (out[0] * 1.01, out[1], out[2])
        else:                                 # UP against FHR in the cross
            out = (out[0], out[1], original(self, up, fhr)[2])
        return out

    assert _caught(monkeypatch, "serve.seqvae_teb.b128", name,
                   InferenceServer, altered)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["parameters_unwritten", "half_batch"])
def test_fault_in_the_replay_on_the_card(card, monkeypatch, fault):
    """On the card the compared steps are replays of the captured step: a
    fault planted in the step is captured with it and has to be caught."""
    from vae_teb_tpu_torch.train.schedules import ClippedAdamW
    from vae_teb_tpu_torch.train.trainer import Trainer
    traffic = {"batch": 16, "pool_windows": 64, "trace_after_groups": 1,
               "trace_groups": 1}
    workload = "train.seqvae_teb.b128"

    def run():
        result, _ = run_cell(workload, 41, 3.0, False, device="cuda",
                             traffic_overrides=traffic)
        return {k for k, c in result["checks"].items()
                if not c["value"] <= c["limit"]}

    sound = run()
    if fault == "half_batch":
        step = Trainer._step

        def faulty(self, y_st, y_ph, x_ph, y_raw, eps=None):
            n = y_st.shape[0] // 2
            return step(self, y_st[:n], y_ph[:n], x_ph[:n], y_raw[:n],
                        None if eps is None else eps[:n])
        monkeypatch.setattr(Trainer, "_step", faulty)
    else:
        step = ClippedAdamW.step

        def faulty(self, closure=None):
            params = [p for p in self.param_groups[0]["params"]
                      if p.grad is not None]
            saved = torch._foreach_mul(params, 1.0)
            norm = step(self)
            torch._foreach_copy_(params, saved)
            return norm
        monkeypatch.setattr(ClippedAdamW, "step", torch.no_grad()(faulty))
    assert run() - sound


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(card, workload):
    """At the cells' own model and frontend, a quarter of their batch."""
    traffic = {"batch": 32, "pool_windows": 128, "checked_requests": 2}
    numbers = control(workload, 31, _lower(workload), device="cuda",
                      traffic_overrides=traffic)
    assert _fails(numbers, workload), numbers
