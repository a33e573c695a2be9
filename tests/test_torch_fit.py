"""The port's training loop at a small size: gradient accumulation against
the JAX Trainer (optax.MultiSteps), in-step normalization against the JAX
package's normalize_field, exact resume from a checkpoint, the fit loop's
semantics (early stop, best-k retention, callbacks), and `cli train`.
"""

import json
import logging
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_teb_tpu.data import default_field_stats as jax_default_field_stats
from vae_teb_tpu.data import normalize_field as jax_normalize_field
from vae_teb_tpu.models import SeqVaeTeb as JaxSeqVaeTeb
from vae_teb_tpu.parallel import data_parallel_mesh
from vae_teb_tpu.train.trainer import Trainer as JaxTrainer
from vae_teb_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from vae_teb_tpu.train.trainer import TrainState
from vae_teb_tpu_torch import SeqVaeTeb, Trainer, TrainerConfig, init_parameters
from vae_teb_tpu_torch.convert import (load_flax_variables, to_torch_layout,
                                       torch_key)
from vae_teb_tpu_torch.data import (Batch, PackedWindowStore,
                                    default_field_stats,
                                    normalize_field_inplace)
from vae_teb_tpu_torch.train import (Callback, Checkpointer, HistoryCallback,
                                     MemoryMonitorCallback, RunConfig,
                                     save_config)

torch.set_num_threads(2)

S, B = 8, 3
SMALL = dict(lstm_hidden_dim=8, lstm_num_layers=2)
FIELDS = ("fhr_st", "fhr_ph", "fhr_up_ph", "fhr")
TIMING = ("epoch_time", "windows_per_sec")


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _batch(seed, b=B):
    return {"fhr_st": _x((b, S, 43), seed), "fhr_ph": _x((b, S, 44), seed + 1),
            "fhr_up_ph": _x((b, S, 130), seed + 2),
            "fhr": _x((b, 16 * S), seed + 3)}


def _raw_batch(seed, b=B):
    """Raw fields as on disk: (B, C, S) coefficients (fhr_st non-negative,
    as scattering moduli are), fhr around 140 bpm."""
    r = np.random.default_rng(seed)
    return {"fhr_st": np.abs(r.standard_normal((b, 43, S))).astype(np.float32),
            "fhr_ph": (5 * r.standard_normal((b, 44, S))).astype(np.float32),
            "fhr_up_ph": (5 * r.standard_normal((b, 130, S))).astype(np.float32),
            "fhr": (140 + 10 * r.standard_normal((b, 16 * S))).astype(np.float32)}


def _stats(default):
    """Statistics with the production transforms, over a raw batch."""
    raw = _raw_batch(99, b=8)
    st = raw["fhr_st"].copy()
    st[:, 1:] = np.log(st[:, 1:] + 1e-6)
    out = {"fhr_st": default("fhr_st", st.mean((0, 2)), st.var((0, 2))),
           "fhr": default("fhr", raw["fhr"].mean(), raw["fhr"].var())}
    for k in ("fhr_ph", "fhr_up_ph"):
        v = np.arcsinh(raw[k])
        out[k] = default(k, v.mean((0, 2)), v.var((0, 2)))
    return out


def _model(dtype=None, seed=1):
    return init_parameters(SeqVaeTeb(**SMALL, seq_len=S, dtype=dtype), seed=seed)


# ---------------------------------------------------------------------------
# gradient accumulation and in-step normalization against the JAX package
# ---------------------------------------------------------------------------

def test_accumulation_matches_jax_trainer():
    """accumulate_grad_batches=2 with SGD (lr 1e-2) on both sides, from the
    same weights with the JAX noise, as tests/test_train.py::
    test_grad_accumulation_matches_averaged_grads drives the JAX Trainer:
    after micro-step 1 no parameter moved (exactly, on both sides); after
    micro-step 2 the port's update equals -lr times the mean of its two
    micro-batch gradients (taken by port trainers without accumulation from
    the same weights and noise) within 1e-6 of their largest entry plus
    two ulps of the parameter (SGD's p - lr * g rounds to p's ulp); and
    the JAX Trainer's update per leaf within 1e-1 of the leaf's largest
    entry (floored at 1e-2 of the largest of any leaf) and 2e-2 relative
    L2 model-wide (measured 6.2e-3 and 2.8e-3), grad_norm per micro-step
    rtol 1e-2 (measured 2.7e-3 and 2e-6). The looser bars are those of
    tests/test_torch_train.py for steps whose gradients meet a ReLU kink:
    at B * S = 24 positions a ReLU input within rounding of 0 falls on
    either side, which happens at micro-step 1 here."""
    lr = 1e-2
    jm = JaxSeqVaeTeb(**SMALL, lstm_schedule="wavefront_pallas")
    zeros = [jnp.zeros((1, S, c)) for c in (43, 44, 130)]
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        *zeros, train=False))
    sd = _model().state_dict()
    variables = jax.tree_util.tree_map_with_path(
        lambda path, _: to_torch_layout(path[-1].key, sd[torch_key(
            tuple(p.key for p in path[1:]))].numpy()), shapes)
    jt = JaxTrainer(jm, JaxTrainerConfig(seed=42, accumulate_grad_batches=2,
                                         prefetch=0),
                    mesh=data_parallel_mesh(devices=jax.devices("cpu")[:1]),
                    tx=optax.sgd(lr))
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=jt.tx.init(variables["params"]),
                       rng=jax.random.PRNGKey(42))
    sgd = lambda params: torch.optim.SGD(params, lr=lr)
    model = load_flax_variables(SeqVaeTeb(**SMALL, seq_len=S), variables)
    acc = Trainer(model, TrainerConfig(seed=42, accumulate_grad_batches=2),
                  device="cpu", optimizer=sgd)
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    batches = [_batch(21), _batch(22)]
    grads = []
    for i, batch in enumerate(batches):
        key = jax.random.split(state.rng)[1]
        eps = torch.tensor(np.asarray(jm.apply(
            {"params": state.params}, rngs={"sample": key},
            method=lambda m: jax.random.normal(m.make_rng("sample"),
                                               (B, S, 32)))))
        # the gradient of this micro-batch at the starting weights
        ref_model = load_flax_variables(SeqVaeTeb(**SMALL, seq_len=S),
                                        variables)
        ref = Trainer(ref_model, TrainerConfig(seed=42), device="cpu",
                      optimizer=sgd)
        ref.train_step(batch, 1e-5, eps=eps)
        grads.append({k: p.grad.clone()
                      for k, p in ref_model.named_parameters()})
        before = state.params
        state, want = jt.train_step(state, batch, 1e-5)
        got = acc.train_step(batch, 1e-5, eps=eps)
        np.testing.assert_allclose(got["grad_norm"].item(),
                                   float(want["grad_norm"]), rtol=1e-2)
        if i == 0:
            assert all(torch.equal(p, start[k])
                       for k, p in model.named_parameters())
            assert all(np.array_equal(a, b) for a, b in zip(
                jax.tree.leaves(before), jax.tree.leaves(state.params)))
    named = dict(model.named_parameters())
    deltas = {}
    for path, new in jax.tree_util.tree_leaves_with_path(state.params):
        path = tuple(p.key for p in path)
        old = variables["params"]
        for p in path:
            old = old[p]
        deltas[torch_key(path)] = to_torch_layout(
            path[-1], np.asarray(new) - np.asarray(old))
    top = max(np.abs(d).max() for d in deltas.values())
    num = den = worst = 0.0
    for k, p in named.items():
        got = (p.detach() - start[k]).numpy()
        # SGD's p - lr * g rounds to p's ulp, whatever the gradient's size
        ulp = 2 * np.spacing(np.abs(start[k].numpy()).max())
        mean = (-lr * (grads[0][k] + grads[1][k]) / 2).numpy()
        scale = lr * max(grads[0][k].abs().max(), grads[1][k].abs().max())
        assert np.abs(got - mean).max() <= 1e-6 * scale + ulp, k
        want = deltas[k]
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-2 * top)
        worst = max(worst, err)
        num += float(((got - want) ** 2).sum())
        den += float((want ** 2).sum())
    assert worst <= 1e-1 and (num / den) ** 0.5 <= 2e-2
    assert acc.optimizer.mini_step == 0 and acc.step == 2


def test_prep_matches_jax_normalize_field():
    """Trainer._prep on raw (B, C, S) fields against the JAX package's
    normalize_field on jnp arrays (log on fhr_st's channels 1.., asinh on
    the phase families, per-channel z-score; fhr z-scored), then the swap
    to (B, S, C): within 1e-6 of each field's largest value (float32
    log/asinh of two libraries; measured at most 2.4e-7)."""
    raw = _raw_batch(5)
    port_stats, jax_stats = _stats(default_field_stats), _stats(
        jax_default_field_stats)
    trainer = Trainer(_model(), TrainerConfig(), device="cpu",
                      normalize_stats=port_stats)
    got = trainer._prep(*trainer._batch(raw))
    for name, g in zip(FIELDS, got):
        w = np.asarray(jax_normalize_field(
            jnp.asarray(raw[name]), name, jax_stats[name],
            channel_axis=-2))
        if name != "fhr":
            w = np.swapaxes(w, 1, 2)
        assert g.shape == w.shape, name
        assert np.abs(g.numpy() - w).max() <= 1e-6 * np.abs(w).max(), name


def test_device_normalize_matches_host():
    """A trainer with normalize_stats fed raw (B, C, S) batches takes the
    same step as a plain trainer fed host-normalized (B, S, C) batches
    (normalize_field_inplace, the loader's path), as the JAX package's
    test_device_normalize_matches_host asks: losses rtol 1e-5 and the
    gradients within 1e-4 model-wide relative L2 (numpy's and torch's
    float32 log and asinh round alike but not always identically;
    measured 1.8e-5)."""
    raw = _raw_batch(6)
    stats = _stats(default_field_stats)
    host = {}
    for k in FIELDS:
        v = normalize_field_inplace(raw[k].copy(), k, stats[k],
                                    channel_axis=-2 if k != "fhr" else -1)
        host[k] = np.ascontiguousarray(np.swapaxes(v, 1, 2)
                                       if k != "fhr" else v)
    eps = torch.as_tensor(_x((B, S, 32), 7))
    runs = []
    for batch, st in ((raw, stats), (host, None)):
        model = _model()
        m = Trainer(model, TrainerConfig(), device="cpu",
                    normalize_stats=st).train_step(batch, 1e-5, eps=eps)
        runs.append((m, [p.grad for p in model.parameters()]))
    for k in runs[0][0]:
        np.testing.assert_allclose(runs[0][0][k].item(), runs[1][0][k].item(),
                                   rtol=1e-5)
    num = sum((a - b).square().sum().item()
              for a, b in zip(runs[0][1], runs[1][1]))
    den = sum(b.square().sum().item() for b in runs[1][1])
    assert (num / den) ** 0.5 <= 1e-4


# ---------------------------------------------------------------------------
# checkpoints and exact resume
# ---------------------------------------------------------------------------

def _epoch_batches(epoch):
    """Three batches an epoch, reshuffled by epoch."""
    order = np.random.default_rng(epoch).permutation(6)[:3]
    return iter([_batch(100 + int(i)) for i in order])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_resume_is_exact(tmp_path, precision):
    """Four epochs straight against two epochs, a new Trainer restored from
    the latest checkpoint, and two more: the parameters, BatchNorm
    statistics, Adam moments (bf16 at rest), accumulated gradients,
    generator state, step count and history (its timings aside) are equal
    bit for bit on the CPU. Three batches an epoch with accumulation over
    two, so a half-accumulated gradient crosses the checkpoint; batches go
    through prefetch."""
    cfg = TrainerConfig(precision=precision, moment_dtype="bf16",
                        accumulate_grad_batches=2, prefetch=2, lr=1e-3)
    dtype = cfg.model_dtype()
    straight = Trainer(_model(dtype), cfg, device="cpu")
    straight.fit(_epoch_batches, epochs=4, log_fn=lambda _: None)

    ckpt = Checkpointer(str(tmp_path / "ckpt"), keep=2)
    first = Trainer(_model(dtype), cfg, device="cpu")
    first.fit(_epoch_batches, epochs=2, checkpointer=ckpt,
              log_fn=lambda _: None)
    assert ckpt.latest()["step"] == 1
    resumed = Trainer(_model(dtype, seed=9), cfg, device="cpu")
    resumed.load_state_dict(Checkpointer(str(tmp_path / "ckpt")).restore())
    resumed.history = pickle.loads(pickle.dumps(first.history))
    resumed.fit(_epoch_batches, epochs=4, checkpointer=ckpt,
                log_fn=lambda _: None, start_epoch=2)

    a, b = straight.state_dict(), resumed.state_dict()
    assert a["model"].keys() == b["model"].keys()
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["mini_step"] == ob["mini_step"] == 0
    assert oa["inner"]["count"] == ob["inner"]["count"] == 6
    for name in ("mu", "nu"):
        assert all(x.dtype == torch.bfloat16 and torch.equal(x, y)
                   for x, y in zip(oa["inner"][name], ob["inner"][name]))
    assert torch.equal(a["generator"], b["generator"])
    assert a["step"] == b["step"] == 12
    assert straight.history["epoch"] == resumed.history["epoch"] == [0, 1, 2, 3]
    for k in straight.history:
        if k not in TIMING:
            assert straight.history[k] == resumed.history[k], k


# ---------------------------------------------------------------------------
# the loop's semantics, on scripted metrics
# ---------------------------------------------------------------------------

def _scripted(trainer, val_losses, train_loss=2.0):
    """Make the trainer's steps return fixed metrics (no model compute): the
    loop's bookkeeping alone is under test."""
    losses = iter(val_losses)

    def metrics(value):
        return {k: torch.tensor(value) for k in
                ("total_loss", "mse_loss", "nll_loss", "kld_loss",
                 "reconstruction_loss")}

    trainer.train_step = lambda batch, beta, eps=None: dict(
        metrics(train_loss), grad_norm=torch.tensor(1.0))
    trainer.eval_step = lambda batch, beta: metrics(next(losses))
    return trainer


def _loop_batches(epoch):
    return iter([_batch(1, b=2)] * 2)


def _val_batch(epoch):
    return iter([_batch(2, b=2)])


def test_fit_early_stop(tmp_path):
    """The monitored metric is the validation total loss; with
    early_stop_patience=2 the loop stops after two epochs without
    improvement, logs why, and every epoch left its history, its log line
    (the JAX package's format) and a checkpoint."""
    cfg = TrainerConfig(epochs=10, early_stop_patience=2, prefetch=0,
                        beta_schedule="linear", beta_anneal_epochs=4)
    trainer = _scripted(Trainer(_model(), cfg, device="cpu"),
                        [3.0, 2.0, 2.5, 2.0, 9.0])
    logs = []
    ckpt = Checkpointer(str(tmp_path / "ckpt"), keep=10)
    history = trainer.fit(_loop_batches, val_batches=_val_batch,
                          checkpointer=ckpt, log_fn=logs.append)
    assert history is trainer.history
    assert history["epoch"] == [0, 1, 2, 3]
    assert history["beta"] == [0.0, 0.25, 0.5, 0.75]
    assert history["val/total_loss"] == [3.0, 2.0, 2.5, 2.0]
    assert history["train/grad_norm"] == [1.0] * 4
    assert logs[0].startswith("epoch 0: train 2.0000 val 3.0000 beta 0.00e+00 (")
    assert logs[0].endswith(" win/s)")
    assert logs[-1] == "early stop at epoch 3 (no improvement for 2 epochs)"
    assert [e["step"] for e in json.load(open(ckpt._index_path))] == [0, 1, 2, 3]


def test_fit_keeps_best_k_plus_latest(tmp_path):
    """Checkpointer(keep=2): the index and the directories hold the best
    two epochs by the monitored metric and the latest; best() and
    restore(best=True) name the best; restore(step=) a kept one; a
    checkpoint that was dropped is not found. The train loss is monitored
    when there is no validation."""
    trainer = _scripted(Trainer(_model(), TrainerConfig(epochs=5, prefetch=0),
                                device="cpu"), [5.0, 1.0, 4.0, 2.0, 6.0])
    ckpt = Checkpointer(str(tmp_path / "ckpt"), keep=2)
    trainer.fit(_loop_batches, val_batches=_val_batch, checkpointer=ckpt,
                log_fn=lambda _: None)
    kept = sorted(e["step"] for e in json.load(open(ckpt._index_path)))
    assert kept == [1, 3, 4]
    assert sorted(os.listdir(ckpt.directory)) == [
        "index.json", "step_00000001", "step_00000003", "step_00000004"]
    assert ckpt.best()["step"] == 1 and ckpt.latest()["step"] == 4
    assert ckpt.best()["path"].endswith("step_00000001")
    assert set(ckpt.restore(best=True)) == {"model", "optimizer",
                                            "generator", "step"}
    assert ckpt.restore(step=3)["step"] == trainer.step
    with pytest.raises(FileNotFoundError):
        ckpt.restore(step=0)
    no_val = _scripted(Trainer(_model(), TrainerConfig(epochs=1, prefetch=0),
                               device="cpu"), [], train_loss=7.0)
    ckpt2 = Checkpointer(str(tmp_path / "ckpt2"))
    no_val.fit(_loop_batches, checkpointer=ckpt2, log_fn=lambda _: None)
    assert ckpt2.latest()["metric"] == 7.0


def test_callbacks_fire_and_failures_are_isolated(tmp_path):
    """on_epoch_end(trainer, epoch) after every epoch and on_fit_end(trainer)
    once; a callback that raises is logged, never fatal, and the others
    still run. HistoryCallback pickles the history; MemoryMonitorCallback
    skips a trainer that is not on a CUDA device."""
    calls, logs = [], []

    class Probe(Callback):
        def on_epoch_end(self, trainer, epoch):
            calls.append(epoch)

        def on_fit_end(self, trainer):
            calls.append("end")

    class Bomb(Callback):
        def on_epoch_end(self, trainer, epoch):
            raise RuntimeError("boom")

        def on_fit_end(self, trainer):
            raise RuntimeError("boom")

    trainer = _scripted(Trainer(_model(), TrainerConfig(epochs=2, prefetch=0),
                                device="cpu"), [])
    path = str(tmp_path / "history.pkl")
    trainer.fit(_loop_batches, log_fn=logs.append,
                callbacks=[Bomb(), Probe(), HistoryCallback(path),
                           MemoryMonitorCallback(log_fn=logs.append)])
    assert calls == [0, 1, "end"]
    assert sum("Bomb" in line and "boom" in line for line in logs) == 3
    with open(path, "rb") as f:
        assert pickle.load(f) == trainer.history
    assert "hbm_mb_in_use" not in trainer.history


def test_trainer_refuses_what_is_not_ported():
    """steps_per_execution > 1 raises, naming its ROADMAP item; nothing runs
    a different configuration silently. The multi-device knobs are ported:
    tp_min_dim without a mesh is read by nothing and the one-device
    trainer runs as before (tests/test_torch_parallel.py drives meshes)."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 2"):
        Trainer(_model(), TrainerConfig(steps_per_execution=2), device="cpu")
    trainer = Trainer(_model(), TrainerConfig(tp_min_dim=256), device="cpu")
    assert trainer.mesh is None and trainer.runner is None


# ---------------------------------------------------------------------------
# cli train
# ---------------------------------------------------------------------------

class _Arrays:
    """Arrays read as a dataset by PackedWindowStore.build."""

    def __init__(self, arrays, raw_layout):
        self.arrays, self.raw_layout = arrays, raw_layout
        self.stats, self.trim_minutes = None, None

    def __len__(self):
        return len(self.arrays["fhr"])

    def read_batch(self, indices):
        idx = list(indices)
        return Batch({k: v[idx] for k, v in self.arrays.items()})


def test_cli_train_and_resume(tmp_path):
    """`cli train --device cpu` on a packed store of 8 model-layout windows
    (and 4 for validation), two epochs at batch 4, then `--resume` with
    epochs raised to 3: exit code 0 both times, the history runs over
    epochs 0-2 with finite losses, the checkpoints continue, and the
    optimizer count carries on from the checkpoint."""
    def arrays(n, seed):
        return {k: np.swapaxes(v, 1, 2) if v.ndim == 3 else v
                for k, v in _raw_batch(seed, b=n).items()}

    for name, n, seed in (("train", 8, 1), ("val", 4, 2)):
        PackedWindowStore.build(_Arrays(
            {k: np.ascontiguousarray(v) for k, v in arrays(n, seed).items()},
            raw_layout=False), str(tmp_path / name))
    cfg = RunConfig(tag="cli", out_dir_base=str(tmp_path / "runs"))
    cfg.dataset.train_paths = [str(tmp_path / "train")]
    cfg.dataset.validation_paths = [str(tmp_path / "val")]
    cfg.dataset.batch_size = 4
    cfg.trainer.epochs = 2
    cfg.trainer.lr = 1e-3
    path = str(tmp_path / "cfg.yaml")
    save_config(cfg, path)

    from vae_teb_tpu_torch.cli import main
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        assert main(["train", "--config", path, "--device", "cpu"]) == 0
        run_dir = cfg.run_dir(create=False)
        ckpt = Checkpointer(os.path.join(run_dir, "model_checkpoints"))
        first = ckpt.restore()
        cfg.trainer.epochs = 3
        save_config(cfg, path)
        assert main(["train", "--config", path, "--device", "cpu",
                     "--resume"]) == 0
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in handlers:
            root.addHandler(h)
        root.setLevel(level)
        logging.getLogger("vae_teb_tpu_torch").handlers.clear()
    with open(os.path.join(run_dir, "train_results", "history.pkl"),
              "rb") as f:
        history = pickle.load(f)
    assert history["epoch"] == [0, 1, 2]
    assert all(np.isfinite(history[k]).all()
               for k in ("train/total_loss", "val/total_loss"))
    last = Checkpointer(os.path.join(run_dir, "model_checkpoints")).restore()
    assert first["step"] == 4 and last["step"] == 6
    assert last["optimizer"]["count"] == first["optimizer"]["count"] + 2
    assert os.path.exists(os.path.join(run_dir, "train_results", "train.log"))
