"""K train steps per execution (`TrainerConfig.steps_per_execution`,
`Trainer.train_multi_step`) at a small size: on the CPU a group is a loop
of `train_step`, equal to K calls of it bit for bit; `fit` groups batches of
one shape and gives what it gives one batch at a time; a checkpoint taken
after a group resumes exactly; `cli train` reads the knob from a config
file. Marked `cuda`: the step replayed as a CUDA graph against eager steps
on the card (the cluster kernels, and at H=128 the grid kernels), which
skip elsewhere. This file imports no JAX, so it runs on the card too:
`python -m pytest tests/test_torch_capture.py -m cuda`.
(tests/test_torch_train.py holds train_multi_step against the JAX
Trainer's.)
"""

import copy
import logging
import os
import pickle
from collections import Counter

import numpy as np
import pytest
import torch

from vae_teb_tpu_torch import SeqVaeTeb, Trainer, TrainerConfig, init_parameters
from vae_teb_tpu_torch.data import Batch, PackedWindowStore
from vae_teb_tpu_torch.train import Checkpointer, RunConfig, save_config

torch.set_num_threads(2)

S, B = 8, 3
SMALL = dict(lstm_hidden_dim=8, lstm_num_layers=2)
FIELDS = ("fhr_st", "fhr_ph", "fhr_up_ph", "fhr")
TIMING = ("epoch_time", "windows_per_sec")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _batch(seed, b=B):
    return {"fhr_st": _x((b, S, 43), seed), "fhr_ph": _x((b, S, 44), seed + 1),
            "fhr_up_ph": _x((b, S, 130), seed + 2),
            "fhr": _x((b, 16 * S), seed + 3)}


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in FIELDS}


def _model(seed=1, **kw):
    return init_parameters(SeqVaeTeb(**{**SMALL, **kw}, seq_len=S), seed=seed)


def _assert_states_equal(a, b):
    """Two Trainer.state_dict()s equal bit for bit: parameters, BatchNorm
    statistics, moments, count, accumulated gradients, generator, step."""
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k].cpu(), b["model"][k].cpu()), k
    oa, ob = a["optimizer"], b["optimizer"]
    if "inner" in oa:
        assert oa["mini_step"] == ob["mini_step"]
        assert (oa["acc"] is None) == (ob["acc"] is None)
        for x, y in zip(oa["acc"] or (), ob["acc"] or ()):
            assert torch.equal(x.cpu(), y.cpu())
        oa, ob = oa["inner"], ob["inner"]
    assert oa["count"] == ob["count"]
    for name in ("mu", "nu"):
        for x, y in zip(oa[name], ob[name]):
            assert torch.equal(x.cpu(), y.cpu()), name
    assert torch.equal(a["generator"], b["generator"])
    assert a["step"] == b["step"]


@pytest.mark.parametrize("accumulate", [1, 2])
def test_train_multi_step_equals_train_steps(accumulate):
    """train_multi_step over a (3, B, ...) stack on the CPU against three
    train_step calls from the same state, with the noise from the trainer's
    generator: every metric at every step ((3,) tensors), and the whole
    state after (the optimizer's count on its device included), are equal
    bit for bit. Under accumulation over 2 the group crosses an update."""
    cfg = TrainerConfig(steps_per_execution=3, lr=1e-3,
                        accumulate_grad_batches=accumulate)
    batches = [_batch(10 + 10 * i) for i in range(3)]
    single = Trainer(_model(), cfg, device="cpu")
    want = [single.train_step(b, 1e-5) for b in batches]
    multi = Trainer(_model(), cfg, device="cpu")
    got = multi.train_multi_step(_stack(batches), 1e-5)
    assert set(got) == set(want[0])
    for k in got:
        assert got[k].shape == (3,)
        assert torch.equal(got[k], torch.stack([m[k] for m in want])), k
    _assert_states_equal(multi.state_dict(), single.state_dict())
    assert multi.step == 3
    inner = getattr(multi.optimizer, "inner", multi.optimizer)
    assert inner.count.dtype == torch.int32
    assert int(inner.count) == (3 if accumulate == 1 else 1)


class _HostGraph:
    """A captured step as the trainer sees one (`train.graphs.StepGraph`),
    emulated on the CPU: capturing runs nothing, and a replay runs the step
    body on the row's fields with the host state it was captured under
    (the accumulation's micro-step) and changes none of the host state (a
    graph replays device work, not Python)."""

    def __init__(self, step, shapes):
        self.step, self.shapes = step, shapes
        self.optimizer = step.__self__.optimizer
        self.micro = getattr(self.optimizer, "mini_step", None)
        self.launches, self.replays = Counter(), 0

    def replay(self, row):
        sizes = [int(np.prod(s)) for s in self.shapes]
        views = [v.view(s) for v, s in zip(row.split(sizes), self.shapes)]
        micro = getattr(self.optimizer, "mini_step", None)
        if micro is not None:
            self.optimizer.mini_step = self.micro
        metrics = self.step(*views, *[None] * (5 - len(views)))
        if micro is not None:
            self.optimizer.mini_step = micro
        self.metrics = tuple(metrics)
        self.replays += 1
        return torch.stack([metrics[k].float() for k in metrics])


def test_replays_advance_the_accumulation(monkeypatch):
    """The capture path of train_multi_step, with each graph emulated on
    the CPU (`_HostGraph`): accumulation over 2 and K=4 over three groups
    (the first eager, then captured per micro-step; the others replay)
    equals twelve train_step calls bit for bit, metrics and state, the
    micro-step and the optimizer's count included. A replay runs no Python,
    so the trainer itself must move the micro-step on after each one."""
    import vae_teb_tpu_torch.train.trainer as trainer_module
    monkeypatch.setattr(trainer_module, "capture_step",
                        lambda step, shapes, *_: _HostGraph(step, shapes))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    cfg = TrainerConfig(steps_per_execution=4, accumulate_grad_batches=2,
                        lr=1e-3)
    batches = [_batch(110 + 10 * i) for i in range(12)]
    single = Trainer(_model(), cfg, device="cpu")
    want = [single.train_step(b, 1e-5) for b in batches]
    multi = Trainer(_model(), cfg, device="cpu")
    multi.captures = True
    got = [multi.train_multi_step(_stack(batches[i:i + 4]), 1e-5)
           for i in range(0, 12, 4)]
    assert sorted(micro for (_, micro) in multi.graphs) == [0, 1]
    assert [g.replays for g in multi.graphs.values()] == [4, 4]
    for k in got[0]:
        assert torch.equal(torch.cat([g[k] for g in got]),
                           torch.stack([m[k] for m in want])), k
    _assert_states_equal(multi.state_dict(), single.state_dict())
    assert multi.optimizer.mini_step == 0
    assert int(multi.optimizer.inner.count) == 6


# batch sizes of the five batches, and the accumulation
FIT_CASES = {"even": ([B] * 5, 1), "ragged": ([B, B, B, B - 1, B], 1),
             "accumulate": ([B] * 5, 2)}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_steps_per_execution(case):
    """fit with steps_per_execution=2 over 5 batches against =1 (as the JAX
    package's tests/test_train.py::test_fit_loop_steps_per_execution drives
    its trainer): two groups and a tail of one, or, with a batch of B - 1
    fourth, groups of 2, 1, 1 and 1 (a batch of another shape closes a
    group); under accumulation over 2 the groups straddle the updates.
    Batches go through prefetch. The final states are equal bit for bit,
    the per-epoch metric means equal, every window is counted, and
    train_multi_step took the groups."""
    sizes, accumulate = FIT_CASES[case]
    batches = [_batch(40 + 10 * i, b) for i, b in enumerate(sizes)]
    groups = []

    def run(spe):
        cfg = TrainerConfig(lr=1e-3, epochs=1, seed=3, prefetch=2,
                            steps_per_execution=spe,
                            accumulate_grad_batches=accumulate)
        trainer = Trainer(_model(), cfg, device="cpu")
        multi = trainer.train_multi_step

        def spy(stacked, beta, eps=None):
            groups.append(tuple(stacked["fhr"].shape[:2]))
            return multi(stacked, beta, eps)

        trainer.train_multi_step = spy
        trainer.fit(lambda e: iter(batches), log_fn=lambda _: None)
        return trainer

    one, two = run(1), run(2)
    want = {"even": [(2, B), (2, B), (1, B)],
            "ragged": [(2, B), (1, B), (1, B - 1), (1, B)],
            "accumulate": [(2, B), (2, B), (1, B)]}[case]
    assert groups == want
    _assert_states_equal(two.state_dict(), one.state_dict())
    assert two.step == 5
    for k in one.history:
        if k not in TIMING:
            assert one.history[k] == two.history[k], k
    for t in (one, two):
        windows = t.history["windows_per_sec"][0] * t.history["epoch_time"][0]
        assert windows == pytest.approx(sum(sizes), rel=1e-6)


def test_resume_after_multi_step_is_exact(tmp_path):
    """A checkpoint taken after train_multi_step groups (accumulation over 2
    with K=3, so a half-accumulated gradient is saved) restores into a new
    trainer that then takes the next group exactly as the first trainer
    does: equal bit for bit, the count restored on its device."""
    cfg = TrainerConfig(steps_per_execution=3, accumulate_grad_batches=2,
                        lr=1e-3)
    batches = [_batch(70 + 10 * i) for i in range(6)]
    first = Trainer(_model(), cfg, device="cpu")
    first.train_multi_step(_stack(batches[:3]), 1e-5)
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save(first.state_dict(), step=0, metric=0.0)
    resumed = Trainer(_model(seed=9), cfg, device="cpu")
    resumed.load_state_dict(Checkpointer(str(tmp_path / "ckpt")).restore())
    assert resumed.optimizer.mini_step == 1
    assert isinstance(resumed.optimizer.inner.count, torch.Tensor)
    want = first.train_multi_step(_stack(batches[3:]), 1e-5)
    got = resumed.train_multi_step(_stack(batches[3:]), 1e-5)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _assert_states_equal(resumed.state_dict(), first.state_dict())
    assert resumed.state_dict()["optimizer"]["inner"]["count"] == 3


def test_load_state_dict_leaves_the_state_it_was_given():
    """Restoring a state and stepping on leaves that state as it was (the
    moments and the accumulated gradient are copied, not taken over), so one
    state restores any number of times to the same trainer state: a step
    from it twice gives the same result bit for bit."""
    cfg = TrainerConfig(accumulate_grad_batches=2, lr=1e-3)
    t = Trainer(_model(), cfg, device="cpu")
    for i in range(3):   # one update, then half an accumulation
        t.train_step(_batch(130 + 10 * i), 1e-5)
    state = copy.deepcopy(t.state_dict())
    kept = copy.deepcopy(state)
    after = []
    for _ in range(2):
        t.load_state_dict(state)
        t.train_step(_batch(160), 1e-5)
        after.append(copy.deepcopy(t.state_dict()))
    _assert_states_equal(state, kept)
    _assert_states_equal(after[0], after[1])


def test_trainer_checks_the_optimizer_can_be_captured():
    """On the card steps_per_execution > 1 replays a CUDA graph of the step,
    which needs an optimizer that reads no host value between steps: the
    default ClippedAdamW, or a torch.optim optimizer built with
    capturable=True; any other raises, naming it. (The check is made for
    a trainer on the card; here the trainer's device is set to one.)"""
    sgd = Trainer(_model(), TrainerConfig(), device="cpu",
                  optimizer=lambda p: torch.optim.SGD(p, lr=1e-2))
    adam = Trainer(_model(), TrainerConfig(), device="cpu",
                   optimizer=lambda p: torch.optim.Adam(p, capturable=True))
    default = Trainer(_model(), TrainerConfig(accumulate_grad_batches=2),
                      device="cpu")
    for t in (sgd, adam, default):
        t.device = torch.device("cuda")
    with pytest.raises(ValueError, match="SGD was not built with capturable"):
        sgd._check_capturable()
    adam._check_capturable()
    default._check_capturable()
    with pytest.raises(ValueError, match="steps_per_execution"):
        Trainer(_model(), TrainerConfig(steps_per_execution=0), device="cpu")


class _Arrays:
    """Arrays read as a dataset by PackedWindowStore.build."""

    def __init__(self, arrays):
        self.arrays, self.raw_layout = arrays, False
        self.stats, self.trim_minutes = None, None

    def __len__(self):
        return len(self.arrays["fhr"])

    def read_batch(self, indices):
        idx = list(indices)
        return Batch({k: v[idx] for k, v in self.arrays.items()})


def test_cli_train_reads_steps_per_execution(tmp_path, monkeypatch):
    """`cli train --device cpu` with `trainer: steps_per_execution: 2` in
    its YAML file: the trainer gets K=2 and fit hands train_multi_step
    groups of two batches (three batches of 4: a group and a tail), and the
    run ends with a checkpoint and a history."""
    rows = [_batch(90 + i, b=4) for i in range(3)]
    arrays = {k: np.ascontiguousarray(np.concatenate([r[k] for r in rows]))
              for k in FIELDS}
    PackedWindowStore.build(_Arrays(arrays), str(tmp_path / "train"))
    cfg = RunConfig(tag="spe", out_dir_base=str(tmp_path / "runs"))
    cfg.dataset.train_paths = [str(tmp_path / "train")]
    cfg.dataset.batch_size = 4
    cfg.trainer.epochs = 1
    cfg.trainer.steps_per_execution = 2
    path = str(tmp_path / "cfg.yaml")
    save_config(cfg, path)
    with open(path) as f:
        assert "steps_per_execution: 2" in f.read()
    seen = []
    multi = Trainer.train_multi_step

    def spy(self, stacked, beta, eps=None):
        seen.append((self.config.steps_per_execution,
                     int(stacked["fhr"].shape[0])))
        return multi(self, stacked, beta, eps)

    monkeypatch.setattr(Trainer, "train_multi_step", spy)
    from vae_teb_tpu_torch.cli import main
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        assert main(["train", "--config", path, "--device", "cpu"]) == 0
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in handlers:
            root.addHandler(h)
        root.setLevel(level)
        logging.getLogger("vae_teb_tpu_torch").handlers.clear()
    assert seen == [(2, 2), (2, 1)]
    run_dir = cfg.run_dir(create=False)
    assert Checkpointer(os.path.join(run_dir, "model_checkpoints")
                        ).restore()["step"] == 3
    with open(os.path.join(run_dir, "train_results", "history.pkl"),
              "rb") as f:
        assert np.isfinite(pickle.load(f)["train/total_loss"]).all()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's CUDA graph and the "
                    "wavefront kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_runs(device, model, cfg, batches, eager_runs=5):
    """The same steps from one state on the card, eagerly `eager_runs`
    times (E1, E2, ...) and as groups of cfg.steps_per_execution (C, whose
    first group is eager and the rest replays). Returns ({run: flat
    snapshot}, the C trainer)."""
    runs, start = {}, None
    for name in [f"E{i + 1}" for i in range(eager_runs)] + ["C"]:
        t = Trainer(copy.deepcopy(model), cfg, device)
        if start is None:
            start = copy.deepcopy(t.state_dict())
        t.load_state_dict(copy.deepcopy(start))
        k = cfg.steps_per_execution
        if name == "C":
            groups = [t.train_multi_step(
                {f: torch.stack([b[f] for b in batches[i:i + k]])
                 for f in FIELDS}, 1e-5) for i in range(0, len(batches), k)]
            metrics = {m: torch.cat([g[m] for g in groups]) for m in groups[0]}
        else:
            steps = [t.train_step(b, 1e-5) for b in batches]
            metrics = {m: torch.stack([s[m] for s in steps]) for m in steps[0]}
        torch.cuda.synchronize()
        runs[name] = _flat(metrics, t.state_dict())
    return runs, t


def _flat(metrics, state):
    """Metrics and state on the host, one tensor a key, prefixed by group:
    metric.<name>, model (parameters and statistics), mu, nu, count,
    generator, step."""
    out = {f"metric.{k}": v.cpu() for k, v in metrics.items()}
    out.update({f"model.{k}": v.detach().cpu().clone()
                for k, v in state["model"].items()})
    opt = state["optimizer"].get("inner", state["optimizer"])
    for name in ("mu", "nu"):
        out.update({f"{name}.{i}": v.detach().cpu().clone()
                    for i, v in enumerate(opt[name])})
    out["count"] = torch.tensor(opt["count"])
    out["mini_step"] = torch.tensor(state["optimizer"].get("mini_step", 0))
    out["generator"] = state["generator"].clone()
    out["step"] = torch.tensor(state["step"])
    return out


def _group_distance(a, b):
    """Per group (the key's prefix; each metric its own), ||a - b|| / ||b||."""
    num, den = {}, {}
    for k in b:
        g = k if k.startswith("metric.") else k.split(".")[0]
        x, y = a[k].double(), b[k].double()
        num[g] = num.get(g, 0.0) + (x - y).square().sum().item()
        den[g] = den.get(g, 0.0) + y.square().sum().item()
    return {g: (num[g] / den[g]) ** 0.5 if den[g] else num[g] ** 0.5
            for g in den}


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [8, 128])
def test_captured_steps_match_eager_on_card(cuda_device, hidden):
    """Four steps at B=8 from one state on the card, eagerly five times and
    as two groups of 2 (the second group replays the captured step; H=128
    takes the grid kernels, whose cooperative launch the graph records).
    The backward on the card is not deterministic (atomic adds in cuDNN's
    weight gradient and in the reflect pad's backward: two eager steps
    from one state differ in most gradient leaves), so the captured run is
    held as chip_smoke.py's phase 14 holds it (`_assert_like_eager`). The
    replays launched the wavefront kernels once a step each, the
    decoder's upsample kernels four times each way, and the LayerNorm
    kernels once each way for each of the model's 115 LayerNorms."""
    from vae_teb_tpu_torch.kernels import launch_counts
    model = init_parameters(SeqVaeTeb(lstm_hidden_dim=hidden,
                                      lstm_num_layers=2, seq_len=S), seed=1)
    batches = [{k: torch.as_tensor(v, device=cuda_device)
                for k, v in _batch(20 + 10 * i, b=8).items()}
               for i in range(4)]
    before = launch_counts()
    runs, trainer = _card_runs(cuda_device, model,
                               TrainerConfig(steps_per_execution=2), batches)
    launched = launch_counts() - before
    _assert_like_eager(runs)
    (graph,) = trainer.graphs.values()
    assert graph.replays == 2
    prefix = "wavefront_grid_" if hidden == 128 else "wavefront_"
    res, bwd = (("wavefront_fwd", f"{prefix}fwd_res_f32"),
                ("wavefront_bwd", f"{prefix}bwd_f32"))
    up, up_bwd = (("upsample_linear2x_fwd", "upsample_linear2x_fwd_f32"),
                  ("upsample_linear2x_bwd", "upsample_linear2x_bwd_f32"))
    ln, ln_bwd = (("layer_norm_fwd", "layer_norm_fwd_f32"),
                  ("layer_norm_bwd", "layer_norm_bwd_f32"))
    assert graph.launches == {res: 1, bwd: 1,
                              ("wavefront_fwd", "residual_launches"): 1,
                              ("wavefront_bwd", "launches"): 1,
                              up: 4, up_bwd: 4,
                              ("upsample_linear2x_fwd", "launches"): 4,
                              ("upsample_linear2x_bwd", "launches"): 4,
                              ln: 115, ln_bwd: 115,
                              ("layer_norm_fwd", "launches"): 115,
                              ("layer_norm_bwd", "launches"): 115}
    assert launched[res] == launched[bwd] == 24   # 6 runs of 4 steps
    assert launched[up] == launched[up_bwd] == 96
    assert launched[ln] == launched[ln_bwd] == 115 * 24


@pytest.mark.cuda
def test_captured_accumulation_matches_eager_on_card(cuda_device):
    """Accumulation over 2 with K=4: eight steps at B=8 from one state on
    the card, eagerly five times and as two groups of 4 (the first eager,
    then one graph per micro-step, each replayed twice in the second
    group), held as the steps without accumulation are; the micro-step,
    the optimizer's count (4 updates) and the step agree exactly."""
    model = init_parameters(SeqVaeTeb(**SMALL, seq_len=S), seed=1)
    batches = [{k: torch.as_tensor(v, device=cuda_device)
                for k, v in _batch(120 + 10 * i, b=8).items()}
               for i in range(8)]
    runs, trainer = _card_runs(
        cuda_device, model,
        TrainerConfig(steps_per_execution=4, accumulate_grad_batches=2),
        batches)
    _assert_like_eager(runs)
    assert sorted((micro, g.replays)
                  for (_, micro), g in trainer.graphs.items()) == [(0, 2),
                                                                   (1, 2)]
    assert int(runs["C"]["count"]) == 4 and int(runs["C"]["step"]) == 8
    assert int(runs["C"]["mini_step"]) == 0


def _assert_like_eager(runs):
    """The captured run C against the eager runs E1, E2, ...: bit for bit in
    what every run gives alike by construction (the count, the micro-step,
    the generator state, the step and the first step's losses, one
    deterministic forward), and in each group of entries (each metric over
    the steps, the model's tensors, each moment) within twice the largest
    relative L2 between two eager runs, or 1e-5 where that is smaller: a
    scalar that the eager runs happen to round alike may still differ by an
    ulp in the captured run (a loss 1.5e-7 apart where five eager runs
    agreed), while a replay's fault moves results by 1e-1 or more."""
    eager = [runs[k] for k in sorted(runs) if k.startswith("E")]
    e1, c = eager[0], runs["C"]
    exact = ["count", "mini_step", "generator", "step"] + [
        k for k in e1 if k.startswith("metric.") and k != "metric.grad_norm"]
    for k in exact:
        first = slice(1) if k.startswith("metric.") else ...
        assert all(torch.equal(r[k][first], e1[k][first])
                   for r in eager + [c]), k
    spread = {}
    for i, a in enumerate(eager):
        for b in eager[i + 1:]:
            for g, d in _group_distance(a, b).items():
                spread[g] = max(spread.get(g, 0.0), d)
    for g, d in _group_distance(c, e1).items():
        assert d <= max(2 * spread[g], 1e-5), (g, d, spread[g])
