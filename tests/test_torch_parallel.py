"""The port's data- and tensor-parallel training against the JAX package
and against its own one-process trainer, on the CPU.

Ranks are spawned by torch.multiprocessing (tests/torch_parallel_worker.py)
and join a gloo process group, one thread each. The JAX side runs its
Trainer on the virtual CPU devices tests/conftest.py forces: a
("data",) mesh of 2 devices, and a 1 x 2 ("data", "model") mesh. Both start
from the port's seeded initialization converted into the flax tree, take
the same global batches of B=4, and use the JAX noise, which the port's
ranks take as the global eps. Each mesh is compiled once, in a module
fixture, while the ranks run. Against the port's one-process Trainer each
step starts from the ranks' full state before it (`Trainer.state_dict()`,
gathered under tensor parallelism), so that each step is compared alone.

Each step is compared alone, from one state. The ranks take each step
from the JAX Trainer's state before it (params, batch_stats, Adam moments
and count, converted to `Trainer.state_dict()` form), and the port's
one-process Trainer each step from the ranks' own state before it
(`Trainer.state_dict()`, gathered under tensor parallelism). Trajectories
run free over three steps at this size cross a kink (B * S = 32
positions: a ReLU or clip input within rounding of its corner), and the
side a run lands on follows its rounding: the port's one-process and
two-rank runs part at step 2 (grad_norm 73.957 against 74.298), as JAX's
one- and two-device meshes do, and JAX's Pallas LSTM and its plain
wavefront schedule part at step 3 on the 1 x 2 mesh (44.794 against
45.582); from one state the steps meet within 2e-6 in grad_norm.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_worker as worker
from vae_teb_tpu.models import SeqVaeTeb as JaxSeqVaeTeb
from vae_teb_tpu.parallel import data_parallel_mesh as jax_data_mesh
from vae_teb_tpu.parallel import hybrid_mesh as jax_hybrid_mesh
from vae_teb_tpu.parallel import tensor_parallel_rule as jax_rule
from vae_teb_tpu.train.trainer import Trainer as JaxTrainer
from vae_teb_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from vae_teb_tpu.train.trainer import TrainState
from vae_teb_tpu_torch import SeqVaeTeb, Trainer, TrainerConfig, init_parameters
from vae_teb_tpu_torch.convert import (flax_path, flax_to_state_dict,
                                       to_torch_layout, torch_key)
from vae_teb_tpu_torch.models import SeqVaeTebClassifier
from vae_teb_tpu_torch.models.blocks import BatchNorm
from vae_teb_tpu_torch.models.inception_time import dropout
from vae_teb_tpu_torch.parallel import Mesh, Sharded, tensor_parallel_rule
from vae_teb_tpu_torch.train import ClassifierConfig, ClassifierTrainer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, B = 8, 4                      # sequence length, global batch
SMALL = dict(lstm_hidden_dim=8, lstm_num_layers=2)
TP_MIN_DIM = 16 * S              # the decoder heads' width, and no other
STEPS, BETA, SEED = 3, 1e-5, 3
LR = TrainerConfig().lr
RANK_TIMEOUT_S = 240
HEADS = {f"decoder.output_{h}.dense.{i}.weight" for h in ("mu", "logvar")
         for i in (0, 1)}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _batch(seed, b=B):
    return {"fhr_st": _x((b, S, 43), seed), "fhr_ph": _x((b, S, 44), seed + 1),
            "fhr_up_ph": _x((b, S, 130), seed + 2),
            "fhr": _x((b, 16 * S), seed + 3)}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Ranks:
    """`world` ranks of torch_parallel_worker.run on `spec`, started at
    once; `results()` waits for them (each must exit 0 within
    RANK_TIMEOUT_S) and loads what each saved."""

    def __init__(self, spec, world, out_dir):
        self.world, self.out_dir = world, str(out_dir)
        spec_path = os.path.join(self.out_dir, "spec.pt")
        torch.save(spec, spec_path)
        self.ctx = mp.start_processes(
            worker.run, args=(world, _free_port(), spec_path, self.out_dir),
            nprocs=world, join=False, start_method="spawn")
        self.deadline = time.time() + RANK_TIMEOUT_S
        self._results = None

    def results(self):
        if self._results is None:
            while not self.ctx.join(timeout=5):
                if time.time() > self.deadline:
                    for p in self.ctx.processes:
                        p.kill()
                    raise TimeoutError(f"ranks still running after "
                                       f"{RANK_TIMEOUT_S} s")
            self._results = [torch.load(os.path.join(self.out_dir,
                                                     f"rank{r}.pt"),
                                        weights_only=False)
                             for r in range(self.world)]
        return self._results


@pytest.fixture(scope="module")
def setup():
    """The JAX model (Pallas LSTM in interpret mode), a flax tree holding
    the port's seeded initialization (structure from eval_shape: nothing
    compiles), the global batches and the JAX noise of each step."""
    jm = JaxSeqVaeTeb(**SMALL, lstm_schedule="wavefront_pallas")
    zeros = [jnp.zeros((1, S, c)) for c in (43, 44, 130)]
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        *zeros, train=False))
    state = init_parameters(SeqVaeTeb(**SMALL, seq_len=S), seed=1).state_dict()
    variables = jax.tree_util.tree_map_with_path(
        lambda path, _: to_torch_layout(path[-1].key, state[torch_key(
            tuple(p.key for p in path[1:]))].numpy()), shapes)
    # the Trainer's noise: step i draws from split(rng_i)[1], then carries
    # rng_{i+1} = split(rng_i)[0]
    rng, eps = jax.random.PRNGKey(SEED), []
    for _ in range(STEPS):
        rng, key = jax.random.split(rng)
        eps.append(np.asarray(jm.apply(
            {"params": variables["params"]}, rngs={"sample": key},
            method=lambda m: jax.random.normal(m.make_rng("sample"),
                                               (B, S, 32)))))
    batches = [_batch(30 + 10 * i) for i in range(STEPS)]
    return dict(jm=jm, variables=variables, state=state, eps=eps,
                batches=batches)


def _spec(setup, tasks, **extra):
    spec = dict(model=dict(SMALL, seq_len=S), state=setup["state"],
                config=dict(seed=SEED, tp_min_dim=TP_MIN_DIM), beta=BETA,
                batches=setup["batches"], eps=setup["eps"], tasks=tasks,
                forced_wait_s=RANK_TIMEOUT_S - 20)
    spec.update(extra)
    return spec


def _port_state(state, step):
    """A JAX TrainState in `Trainer.state_dict()` form: the flax params and
    batch_stats in the port's names and layout, and the Adam moments and
    count of the packed optax chain (every leaf of the small model is in
    flat_param_fusion's flat vector, in the params tree's leaf order)."""
    import optax
    host = jax.device_get(state)
    model = SeqVaeTeb(**SMALL, seq_len=S)
    model_state = flax_to_state_dict({"params": host.params,
                                      "batch_stats": host.batch_stats}, model)
    adam = [x for x in jax.tree_util.tree_leaves(
        host.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)]
    (adam,) = adam
    assert not adam.mu["big"]
    moments = {}
    for name in ("mu", "nu"):
        flat, off = np.asarray(getattr(adam, name)["flat"]), 0
        for path, leaf in jax.tree_util.tree_leaves_with_path(host.params):
            keys = tuple(p.key for p in path)
            n = leaf.size
            moments.setdefault(name, {})[torch_key(keys)] = torch.tensor(
                np.ascontiguousarray(to_torch_layout(
                    keys[-1], flat[off:off + n].reshape(leaf.shape), keys)))
            off += n
        assert off == flat.size
    names = [k for k, _ in model.named_parameters()]
    return {"model": model_state,
            "optimizer": {"count": int(adam.count),
                          "mu": [moments["mu"][k] for k in names],
                          "nu": [moments["nu"][k] for k in names]},
            "generator": torch.Generator().get_state(), "step": step}


def _jax_run(setup, mesh, forced_path):
    """STEPS steps of the JAX Trainer on `mesh`: per step (metrics, params
    and batch_stats in the port's names and layout); its state before each
    step in port form is written to `forced_path` for the ranks. Returns
    the steps, the states before them and the paths of the sharded
    leaves."""
    jt = JaxTrainer(setup["jm"], JaxTrainerConfig(seed=SEED, prefetch=0,
                                                  tp_min_dim=TP_MIN_DIM),
                    mesh=mesh)
    v = setup["variables"]
    state = jt.replicate(TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=jt.tx.init(v["params"]),
        rng=jax.random.PRNGKey(SEED)))
    steps, before = [], []
    for i, batch in enumerate(setup["batches"]):
        before.append(_port_state(state, i))
        state, m = jt.train_step(state, batch, BETA)
        # home the result in the input's layout again, so that the next
        # step reuses this compile
        state = jt.replicate(state)
        flat = {}
        for coll in ("params", "batch_stats"):
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                    getattr(state, coll)):
                keys = tuple(p.key for p in path)
                flat[torch_key(keys)] = to_torch_layout(
                    keys[-1], np.asarray(leaf), keys)
        steps.append(({k: float(x) for k, x in m.items()}, flat))
    torch.save(before, forced_path + ".tmp")
    os.replace(forced_path + ".tmp", forced_path)
    sharded = sorted(
        "/".join(p.key for p in path) for path, leaf in
        jax.tree_util.tree_leaves_with_path(state.params)
        if len(leaf.sharding.spec) == 2 and leaf.sharding.spec[1] == "model")
    return steps, before, sharded


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    return _unit_specs(tmp_path_factory)


@pytest.fixture(scope="module")
def data_parallel(setup, units, tmp_path_factory):
    """Two data-parallel ranks: their tasks start first and run while the
    JAX Trainer compiles for its 2-device mesh; then they take JAX's steps
    from its states."""
    out = tmp_path_factory.mktemp("dp")
    forced = str(out / "forced.pt")
    ranks = _Ranks(_spec(setup, ["batch_norm", "noise", "steps",
                                 "early_stop", "checkpoint", "classifier",
                                 "forced"],
                         forced_path=forced, **units), 2, out)
    steps, before, _ = _jax_run(
        setup, jax_data_mesh(devices=jax.devices("cpu")[:2]), forced)
    return ranks.results(), steps, before


@pytest.fixture(scope="module")
def hybrid(setup, tmp_path_factory):
    """Two ranks as 1 data x 2 model, the heads sharded; the JAX Trainer on
    its 1 x 2 mesh with the same tp_min_dim."""
    out = tmp_path_factory.mktemp("hybrid")
    forced = str(out / "forced.pt")
    ranks = _Ranks(_spec(setup, ["steps", "resume", "forced"], n_model=2,
                         resume_path=str(out / "resume.pt"),
                         forced_path=forced), 2, out)
    steps, before, sharded = _jax_run(
        setup, jax_hybrid_mesh(1, 2, devices=jax.devices("cpu")[:2]), forced)
    return ranks.results(), steps, before, sharded, str(out / "resume.pt")


def _one_process_steps(setup, before):
    """The port's one-process Trainer, loaded with the ranks' full state
    before each step, taking that step on the global batch and noise: per
    step (metrics, parameters and buffers)."""
    steps = []
    for state, batch, eps in zip(before, setup["batches"], setup["eps"]):
        trainer = Trainer(SeqVaeTeb(**SMALL, seq_len=S),
                          TrainerConfig(seed=SEED, prefetch=0), device="cpu")
        trainer.load_state_dict(state)
        m = trainer.train_step(batch, BETA, eps=torch.tensor(eps))
        steps.append(({k: v.item() for k, v in m.items()},
                      {k: v.numpy().copy() for k, v in
                       trainer.model.state_dict().items()}))
    return steps


def _assert_step_matches(got, want, start, step, what):
    """One step's metrics, parameters (`start`: before the step) and
    statistics at the module's bars."""
    (gm, gp), (wm, wp) = got, want
    assert set(gm) == set(wm)
    for k in wm:
        rtol = 1e-2 if k == "grad_norm" and step else 1e-4
        np.testing.assert_allclose(gm[k], wm[k], rtol=rtol,
                                   err_msg=f"{what}: {k}, step {step}")
    n = far = num = den = 0
    for k, w in wp.items():
        g = gp[k]
        assert g.shape == w.shape, k
        if k.endswith(("running_mean", "running_var")):
            assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30), \
                f"{what}: {k}, step {step}"
            continue
        d = g - w
        n += d.size
        far += int((np.abs(d) > LR / 100).sum())
        num += float((d * d).sum())
        den += float(((w - start[k]) ** 2).sum())
    assert far / n <= 2e-2, f"{what}: {far}/{n} elements apart, step {step}"
    assert (num / den) ** 0.5 <= 2e-2, f"{what}: rel-L2, step {step}"


def _start(setup):
    return {k: v.numpy() for k, v in setup["state"].items()}


def _assert_steps_match(ranks, jax_steps, jax_before, setup, reference):
    """Rank 0's steps, each from one state: JAX's steps against the ranks'
    steps from JAX's state before each, or the ranks' own steps against
    one-process steps from the ranks' state before each."""
    if reference == "jax":
        got, want, before = ranks[0]["forced"], jax_steps, jax_before
    else:
        own = ranks[0]["steps"]
        got = list(zip(own["metrics"], own["params"]))
        before = own["before"]
        want = _one_process_steps(setup, before)
    for i in range(STEPS):
        start = {k: v.numpy() for k, v in before[i]["model"].items()}
        _assert_step_matches(got[i], want[i], start, i, reference)


# ---------------------------------------------------------------------------
# the mesh and the rule
# ---------------------------------------------------------------------------

def test_tensor_parallel_rule_selects_jax_leaves_at_production_width(
        cpu_mesh_devices):
    """At min_dim=2048 the port's rule shards exactly the Dense weights
    whose flax kernels JAX's rule shards on a 4 x 2 mesh (the four
    4800x4800 decoder heads), evaluated on shapes only (jax.eval_shape;
    the port's model on the meta device)."""
    jm = JaxSeqVaeTeb()
    x = [jax.ShapeDtypeStruct((1, 300, c), jnp.float32) for c in (43, 44, 130)]
    shapes = jax.eval_shape(lambda a, b, c: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        a, b, c, train=False), *x)
    rule = jax_rule(jax_hybrid_mesh(4, 2, devices=cpu_mesh_devices))
    want = sorted("/".join(p.key for p in path) for path, leaf in
                  jax.tree_util.tree_leaves_with_path(shapes["params"])
                  if rule(leaf).spec == jax.sharding.PartitionSpec(None,
                                                                   "model"))
    with torch.device("meta"):
        model = SeqVaeTeb()
    mesh = Mesh(("data", "model"), {"data": 4, "model": 2},
                {"data": 0, "model": 1})
    port_rule = tensor_parallel_rule(mesh)
    got = sorted("/".join(flax_path(n, p.dim())) for n, p in
                 model.named_parameters() if isinstance(port_rule(p), Sharded)
                 and n.endswith("weight") and p.dim() == 2
                 and isinstance(model.get_submodule(n[:-7]),
                                torch.nn.Linear))
    assert len(want) == 4 and got == want
    sh = port_rule(model.decoder.output_mu.dense[0].weight)
    assert (sh.axis, sh.index, sh.count) == (0, 1, 2)
    assert sh.block(4800) == slice(2400, 4800)


def test_mesh_layout_and_shardings():
    """hybrid_mesh's layout rank = d * n_model + m, checked without a
    process group through the shardings a Mesh gives: batch rows by the
    data coordinate, stacked batches on axis 1, replicated is the
    identity; the rule leaves biases and indivisible widths replicated."""
    from vae_teb_tpu_torch.parallel import (batch_sharding, replicated_sharding,
                                            shard_batch, stacked_batch_sharding)
    mesh = Mesh(("data", "model"), {"data": 2, "model": 2},
                {"data": 1, "model": 0})
    x = np.arange(8 * 3).reshape(8, 3)
    np.testing.assert_array_equal(batch_sharding(mesh)(x), x[4:])
    stack = np.arange(2 * 8).reshape(2, 8)
    np.testing.assert_array_equal(stacked_batch_sharding(mesh)(stack),
                                  stack[:, 4:])
    assert replicated_sharding(mesh)(x) is x
    out = shard_batch({"fhr": torch.arange(8), "guid": list("abcdefgh")}, mesh)
    assert out["fhr"].tolist() == [4, 5, 6, 7] and out["guid"] == list("abcdefgh")
    rule = tensor_parallel_rule(mesh, min_dim=4)
    assert isinstance(rule(torch.zeros(6, 3)), Sharded)
    assert not isinstance(rule(torch.zeros(6)), Sharded)
    assert not isinstance(rule(torch.zeros(5, 3)), Sharded)
    assert not isinstance(rule(torch.zeros(2, 3)), Sharded)
    with pytest.raises(ValueError):
        batch_sharding(mesh)(np.zeros(5))


# ---------------------------------------------------------------------------
# data parallel
# ---------------------------------------------------------------------------

def _unit_specs(tmp_path_factory):
    r = np.random.default_rng(11)
    base = tmp_path_factory.mktemp("ckpt")
    cls_model = dict(seq_len=S, **SMALL, classifier_depth=3,
                     classifier_filters=4, classifier_dropout=0.2)
    cls_state = init_parameters(SeqVaeTebClassifier(**cls_model),
                                seed=2).state_dict()
    cls_batches = []
    for i in range(2):
        b = _batch(70 + 10 * i)
        b["label"] = np.array([0, 1, 1, 0])
        cls_batches.append(b)
    return {
        "bn": {"x": (1.0 + 2.0 * r.standard_normal((6, 5, 4))).astype(
                   np.float32),
               "g": r.standard_normal((6, 5, 4)).astype(np.float32),
               "w": (1 + 0.3 * r.standard_normal(4)).astype(np.float32),
               "b": (0.3 * r.standard_normal(4)).astype(np.float32)},
        "noise": {"local_batch": 2, "eps": _x((4, 3, 4), 12)},
        "early_stop": {"epochs": 5,
                       "batches": [_batch(50, b=2), _batch(60, b=2)]},
        "checkpoint": {"shared": str(base / "shared"),
                       "own": str(base / "own")},
        "classifier": {"model": cls_model, "state": cls_state,
                       "config": dict(lr=1e-3, seed=5),
                       "batches": cls_batches},
    }


def test_synced_batch_norm_equals_one_process(data_parallel, units):
    """Each rank's BatchNorm on its 3 of 6 rows, statistics synced over the
    two ranks: output, input gradient, parameter gradients (summed over
    the ranks) and running statistics equal one process over the 6 rows,
    within 1e-6 of each array's largest entry (fp32, summation order)."""
    ranks = data_parallel[0]
    spec = units["bn"]
    x = torch.tensor(spec["x"], requires_grad=True)
    bn = BatchNorm(4).train()
    bn.weight.data.copy_(torch.tensor(spec["w"]))
    bn.bias.data.copy_(torch.tensor(spec["b"]))
    y = bn(x)
    (y * torch.tensor(spec["g"])).sum().backward()
    want = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}
    for r, res in enumerate(ranks):
        got = res["batch_norm"]
        for k, w in want.items():
            if k in ("y", "dx"):
                w = w[3 * r:3 * (r + 1)]
            bar = 1e-6 * np.abs(w).max()
            assert np.abs(got[k] - w).max() <= bar, (r, k)


def test_noise_rows_are_the_one_process_draws(data_parallel):
    """Under noise_rows each rank's z noise, caller eps and per-element
    dropout mask are its rows of what one process draws for the global
    batch from the same generator, bit for bit; the attention's broadcast
    mask is the same on both ranks and equals the one-process mask."""
    ranks = data_parallel[0]
    gen = torch.Generator().manual_seed(7)
    z = torch.randn((4, 3, 4), generator=gen)
    mask = dropout(torch.ones(4, 3, 4), 0.5, True, gen)
    shared = dropout(torch.ones(4, 2, 3, 3), 0.5, True, gen, (1, 1, 3, 3))
    eps = _x((4, 3, 4), 12)
    for r, res in enumerate(ranks):
        got, rows = res["noise"], slice(2 * r, 2 * (r + 1))
        np.testing.assert_array_equal(got["z"], z[rows].numpy())
        np.testing.assert_array_equal(got["z_eps"], eps[rows])
        np.testing.assert_array_equal(got["mask"], mask[rows].numpy())
        np.testing.assert_array_equal(got["shared"], shared[rows].numpy())


@pytest.mark.parametrize("reference", ["jax", "one_process"])
def test_data_parallel_steps_match(data_parallel, setup, reference):
    """Two data-parallel ranks, B=2 each, three fp32 steps with the JAX
    noise as the global eps: per-step losses, grad_norm, parameters and
    BatchNorm statistics against the JAX Trainer on a 2-device data mesh,
    and against the port's one-process Trainer over the same global batch
    from the same state, at the module's bars; then eval_step, averaged
    over the ranks, against one process on the global batch (rtol 1e-5).
    The ranks agree with each other bit for bit (metrics, parameters)."""
    ranks, jax_steps, jax_before = data_parallel
    a, b = (r["steps"] for r in ranks)
    assert a["metrics"] == b["metrics"] and a["eval"] == b["eval"]
    for i in range(STEPS):
        assert all(np.array_equal(a["params"][i][k], b["params"][i][k])
                   for k in a["params"][i])
    _assert_steps_match(ranks, jax_steps, jax_before, setup, reference)
    if reference == "one_process":     # eval_step over the data group
        trainer = Trainer(SeqVaeTeb(**SMALL, seq_len=S),
                          TrainerConfig(seed=SEED, prefetch=0), device="cpu")
        trainer.load_state_dict(a["final"])
        want = trainer.eval_step(setup["batches"][0], BETA)
        for k, v in want.items():
            np.testing.assert_allclose(a["eval"][k], v.item(), rtol=1e-5,
                                       err_msg=k)


def test_ranks_agree_on_early_stopping(data_parallel):
    """Ranks whose batches, and local losses, differ keep one history, log
    the same early stop and stop at the same epoch."""
    ranks = data_parallel[0]
    a, b = (r["early_stop"] for r in ranks)
    assert a["own_loss"] != b["own_loss"]
    assert a["history"] == b["history"]
    assert a["logs"] == b["logs"]
    assert len(a["history"]["epoch"]) >= 2


def test_only_rank_zero_writes_checkpoints(data_parallel):
    """fit's checkpoints and a direct save: rank 0 writes, rank 1 writes
    nothing; every rank restores rank 0's file, which holds its live
    state."""
    ranks = data_parallel[0]
    assert ranks[0]["checkpoint"]["own_files"] == ["index.json",
                                                   "step_00000000"]
    assert ranks[1]["checkpoint"]["own_files"] == []
    for res in ranks:
        c = res["checkpoint"]
        assert c["restored"].keys() == c["live"].keys()
        assert all(np.array_equal(c["restored"][k], c["live"][k])
                   for k in c["live"])


def test_data_parallel_classifier_matches_one_process(data_parallel, units):
    """ClassifierTrainer on two ranks (synced BatchNorm, the global batch's
    noise and dropout masks from the generator, averaged gradients and
    metrics), two steps against one process on the global batches: every
    metric rtol 1e-4, parameters and statistics at the module's bars. The
    ranks agree bit for bit."""
    ranks = data_parallel[0]
    c = units["classifier"]
    model = SeqVaeTebClassifier(**c["model"])
    model.load_state_dict(c["state"])
    trainer = ClassifierTrainer(model, ClassifierConfig(**c["config"]),
                                device="cpu")
    a, b = (r["classifier"] for r in ranks)
    assert a["metrics"] == b["metrics"]
    assert all(np.array_equal(a["params"][k], b["params"][k])
               for k in a["params"])
    for i, batch in enumerate(c["batches"]):
        want = trainer.train_step(batch, batch["label"])
        for k, v in want.items():
            np.testing.assert_allclose(a["metrics"][i][k], v.item(),
                                       rtol=1e-4, err_msg=f"{k}, step {i}")
    wp = {k: v.detach().numpy() for k, v in trainer.model.state_dict().items()}
    start = {k: v.numpy() for k, v in c["state"].items()}
    _assert_step_matches(({}, a["params"]), ({}, wp), start, 1, "classifier")


# ---------------------------------------------------------------------------
# tensor parallel (1 data x 2 model)
# ---------------------------------------------------------------------------

def test_hybrid_shards_the_same_leaves_as_jax(hybrid):
    """At tp_min_dim = 16 S both packages shard exactly the small decoder's
    four head kernels; each rank holds half the rows of each, and of their
    Adam moments, and every other parameter whole."""
    ranks, _, _, jax_sharded, _ = hybrid
    assert sorted("/".join(flax_path(k, 2)) for k in HEADS) == jax_sharded
    full = dict(SeqVaeTeb(**SMALL, seq_len=S).named_parameters())
    for res in ranks:
        st = res["steps"]
        assert sorted(st["sharded"]) == sorted(HEADS)
        for k, p in full.items():
            want = ((p.shape[0] // 2,) + tuple(p.shape[1:]) if k in HEADS
                    else tuple(p.shape))
            assert st["local_shapes"][k] == want, k
            assert st["moment_shapes"][k] == want, k


@pytest.mark.parametrize("reference", ["jax", "one_process"])
def test_hybrid_steps_match(hybrid, setup, reference):
    """Three fp32 steps of the 1 x 2 run (the heads column-parallel, their
    features all-gathered before the LayerNorm that follows) against the
    JAX Trainer on its 1 x 2 mesh and against the port's one-process
    Trainer from the same state, at the module's bars, on the gathered
    full parameters."""
    ranks, jax_steps, jax_before, _, _ = hybrid
    a, b = (r["steps"] for r in ranks)
    assert a["metrics"] == b["metrics"]
    assert [m for m, _ in ranks[0]["forced"]] == \
        [m for m, _ in ranks[1]["forced"]]
    _assert_steps_match(ranks, jax_steps, jax_before, setup, reference)


def test_hybrid_state_dict_is_full_and_loads_anywhere(hybrid, setup):
    """The 1 x 2 trainer's state_dict() after two steps holds full arrays
    (the heads gathered, their moments too). Loaded into a fresh 1 x 2
    trainer, the third step is bit for bit the running trainer's; loaded
    into a one-process trainer, it continues as the 1 x 2 run does, at the
    module's bars."""
    ranks, _, _, _, resume_path = hybrid
    state = torch.load(resume_path, weights_only=False)
    full = dict(SeqVaeTeb(**SMALL, seq_len=S).state_dict())
    assert {k: tuple(v.shape) for k, v in state["model"].items()} == \
        {k: tuple(v.shape) for k, v in full.items()}
    names = [k for k, _ in SeqVaeTeb(**SMALL, seq_len=S).named_parameters()]
    for k in HEADS:
        i = names.index(k)
        assert tuple(state["optimizer"]["mu"][i].shape) == \
            tuple(full[k].shape)
    for res in ranks:
        (ma, pa), (mb, pb) = res["resume"]["continued"], \
            res["resume"]["reloaded"]
        assert ma == mb
        assert all(np.array_equal(pa[k], pb[k]) for k in pa)
    model = SeqVaeTeb(**SMALL, seq_len=S)
    trainer = Trainer(model, TrainerConfig(seed=SEED, prefetch=0),
                      device="cpu")
    trainer.load_state_dict(state)
    start = {k: v.numpy().copy() for k, v in state["model"].items()}
    m = trainer.train_step(setup["batches"][-1], BETA,
                           eps=torch.tensor(setup["eps"][-1]))
    got = ({k: v.item() for k, v in m.items()},
           {k: v.numpy() for k, v in trainer.model.state_dict().items()})
    _assert_step_matches(got, ranks[0]["resume"]["continued"], start, 1,
                         "one process from the 1 x 2 state")


# ---------------------------------------------------------------------------
# cli train --multihost
# ---------------------------------------------------------------------------

def _cli_store(tmp_path):
    from vae_teb_tpu_torch.data import PackedWindowStore
    from vae_teb_tpu_torch.train import RunConfig, save_config

    class Arrays:
        raw_layout, stats, trim_minutes = False, None, None

        def __init__(self, arrays):
            self.arrays = arrays

        def __len__(self):
            return len(self.arrays["fhr"])

        def read_batch(self, indices):
            from vae_teb_tpu_torch.data.dataset import Batch
            return Batch({k: v[list(indices)] for k, v in self.arrays.items()})

    for name, n, seed in (("train", 8, 1), ("val", 4, 2)):
        PackedWindowStore.build(Arrays(_batch(seed, b=n)),
                                str(tmp_path / name))
    cfg = RunConfig(tag="mh", out_dir_base=str(tmp_path / "runs"))
    cfg.dataset.train_paths = [str(tmp_path / "train")]
    cfg.dataset.validation_paths = [str(tmp_path / "val")]
    cfg.dataset.batch_size = 2
    cfg.dataset.eval_batch_size = 2
    cfg.trainer.epochs = 1
    path = str(tmp_path / "cfg.yaml")
    save_config(cfg, path)
    return cfg, path


def _torchrun(path, world, *flags):
    """`cli train --multihost --device cpu` as `world` ranks with the
    environment torchrun gives each; their exit codes."""
    port = str(_free_port())
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=port, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "vae_teb_tpu_torch.cli", "train",
             "--config", path, "--multihost", "--device", "cpu",
             "--plot-every", "0", *flags], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    codes = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        codes.append((p.returncode, err.decode()[-2000:]))
    return codes


def test_cli_train_multihost_two_ranks(tmp_path):
    """Two CPU ranks of `cli train --multihost` (per-device batch 2, global
    4) on a packed store of 8 windows: both exit 0, each logs to its own
    train_rank<r>.log, rank 0 writes the checkpoint and the history."""
    cfg, path = _cli_store(tmp_path)
    codes = _torchrun(path, 2)
    assert [c for c, _ in codes] == [0, 0], codes
    run_dir = cfg.run_dir(create=False)
    logs = sorted(os.listdir(os.path.join(run_dir, "train_results")))
    assert "train_rank0.log" in logs and "train_rank1.log" in logs
    assert "train.log" not in logs and "history.pkl" in logs
    with open(os.path.join(run_dir, "train_results", "train_rank1.log")) as f:
        text = f.read()
    assert "global batch 4" in text and "epoch 0" in text
    ckpts = os.listdir(os.path.join(run_dir, "model_checkpoints"))
    assert "step_00000000" in ckpts


def test_cli_model_parallel_must_divide_the_world(tmp_path):
    """--model-parallel 3 on two ranks exits 2 on both."""
    _, path = _cli_store(tmp_path)
    codes = _torchrun(path, 2, "--model-parallel", "3")
    assert [c for c, _ in codes] == [2, 2], codes
    assert all("does not divide 2 devices" in err for _, err in codes)


@pytest.mark.slow
def test_two_by_two_steps_match_jax(setup, tmp_path):
    """Four ranks as 2 data x 2 model (rank = d * 2 + m): each step from the
    JAX Trainer's state on its 2 x 2 mesh, at the module's bars; the ranks
    of a model group hold the same rows and agree bit for bit."""
    forced = str(tmp_path / "forced.pt")
    ranks = _Ranks(_spec(setup, ["forced"], n_model=2, forced_path=forced),
                   4, tmp_path)
    steps, before, sharded = _jax_run(
        setup, jax_hybrid_mesh(2, 2, devices=jax.devices("cpu")[:4]), forced)
    ranks = ranks.results()
    assert len(sharded) == 4
    metrics = [[m for m, _ in r["forced"]] for r in ranks]
    assert metrics[0] == metrics[1] == metrics[2] == metrics[3]
    for i in range(STEPS):
        start = {k: v.numpy() for k, v in before[i]["model"].items()}
        _assert_step_matches(ranks[0]["forced"][i], steps[i], start, i,
                             "2 x 2")
