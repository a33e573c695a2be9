"""One rank of the port's data- and tensor-parallel CPU tests.

`run(rank, world, port, spec_path, out_dir)` is spawned by
tests/test_torch_parallel.py through torch.multiprocessing: it joins a
gloo process group on the CPU (one thread), runs the tasks the spec names
and saves what each produced to out_dir/rank<r>.pt. It imports torch and
the port only, so a rank starts in seconds.
"""

import copy
import os
import time

import torch
import torch.distributed as dist

FIELDS = ("fhr_st", "fhr_ph", "fhr_up_ph", "fhr")


def _model(spec, dtype=None):
    from vae_teb_tpu_torch import SeqVaeTeb
    model = SeqVaeTeb(**spec["model"], dtype=dtype)
    model.load_state_dict(spec["state"])
    return model


def _params(trainer):
    """The full parameters and buffers after a step (gathered under tensor
    parallelism), as numpy."""
    return {k: v.numpy().copy()
            for k, v in trainer.state_dict()["model"].items()}


def _metrics(m):
    return {k: v.item() for k, v in m.items()}


def task_batch_norm(spec, mesh, rank):
    """A synced BatchNorm on this rank's rows of x: output, input gradient,
    parameter gradients summed over the ranks, running statistics."""
    from vae_teb_tpu_torch.models.blocks import BatchNorm
    from vae_teb_tpu_torch.train.distributed import sync_batch_norm
    x, g, w, b = (torch.tensor(spec["bn"][k]) for k in ("x", "g", "w", "b"))
    rows = slice(rank * x.shape[0] // 2, (rank + 1) * x.shape[0] // 2)
    bn = BatchNorm(x.shape[-1]).train()
    bn.weight.data.copy_(w)
    bn.bias.data.copy_(b)
    sync_batch_norm(bn, mesh.group("data"), mesh.axis_size("data"))
    xl = x[rows].clone().requires_grad_(True)
    y = bn(xl)
    (y * g[rows]).sum().backward()
    grads = torch.stack([bn.weight.grad, bn.bias.grad])
    dist.all_reduce(grads)
    return {"y": y.detach().numpy(), "dx": xl.grad.numpy(),
            "dw": grads[0].numpy(), "db": grads[1].numpy(),
            "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


def task_noise(spec, mesh, rank):
    """What a rank draws under noise_rows: sample_z's eps from a generator
    and from a caller's global eps, a per-element dropout mask and the
    attention's broadcast mask."""
    from vae_teb_tpu_torch.models.inception_time import dropout
    from vae_teb_tpu_torch.models.vae_teb import sample_z
    from vae_teb_tpu_torch.parallel import noise_rows
    b = spec["noise"]["local_batch"]
    enc = {"mu_post": torch.zeros(b, 3, 4), "logvar_post": torch.zeros(b, 3, 4)}
    gen = torch.Generator().manual_seed(7)
    with noise_rows(mesh.coords["data"], mesh.axis_size("data")):
        z = sample_z(enc, False, gen)
        z_eps = sample_z(enc, False, eps=torch.tensor(spec["noise"]["eps"]))
        mask = dropout(torch.ones(b, 3, 4), 0.5, True, gen)
        shared = dropout(torch.ones(b, 2, 3, 3), 0.5, True, gen,
                         (1, 1, 3, 3))
    return {"z": z.numpy(), "z_eps": z_eps.numpy(), "mask": mask.numpy(),
            "shared": shared.numpy()}


def task_steps(spec, mesh, rank):
    """Train steps on this rank's rows of the spec's global batches with
    the spec's global eps: per step the full state before it, the metrics
    and the full parameters after it; eval_step on batch 0 and the final
    state; the local shapes of the parameters and moments."""
    from vae_teb_tpu_torch import Trainer, TrainerConfig
    from vae_teb_tpu_torch.parallel import shard_batch
    cfg = TrainerConfig(**spec["config"], prefetch=0)
    trainer = Trainer(_model(spec), cfg, device="cpu", mesh=mesh)
    out = {"metrics": [], "params": [], "before": []}
    for i, batch in enumerate(spec["batches"]):
        out["before"].append(copy.deepcopy(trainer.state_dict()))
        m = trainer.train_step(shard_batch(batch, mesh), spec["beta"],
                               eps=torch.tensor(spec["eps"][i]))
        out["metrics"].append(_metrics(m))
        out["params"].append(_params(trainer))
    out["eval"] = _metrics(trainer.eval_step(shard_batch(spec["batches"][0],
                                                         mesh), spec["beta"]))
    out["final"] = copy.deepcopy(trainer.state_dict())
    out["local_shapes"] = {k: tuple(p.shape) for k, p in
                           trainer.model.named_parameters()}
    out["moment_shapes"] = {
        k: tuple(trainer.optimizer.state[p]["mu"].shape)
        for k, p in trainer.model.named_parameters()}
    out["sharded"] = sorted(trainer.runner.sharded)
    return out


def task_resume(spec, mesh, rank):
    """Under the mesh: the full state after all but the last step (saved
    by rank 0 for the parent), the last step taken by the running trainer
    and by a fresh trainer that loaded that full state."""
    from vae_teb_tpu_torch import Trainer, TrainerConfig
    from vae_teb_tpu_torch.parallel import shard_batch
    cfg = TrainerConfig(**spec["config"], prefetch=0)
    *head, last = range(len(spec["batches"]))

    def step(trainer, i):
        return trainer.train_step(shard_batch(spec["batches"][i], mesh),
                                  spec["beta"],
                                  eps=torch.tensor(spec["eps"][i]))

    trainer = Trainer(_model(spec), cfg, device="cpu", mesh=mesh)
    for i in head:
        step(trainer, i)
    state = copy.deepcopy(trainer.state_dict())
    if rank == 0:
        torch.save(state, spec["resume_path"])
    a = _metrics(step(trainer, last))
    fresh = Trainer(_model(spec), cfg, device="cpu", mesh=mesh)
    fresh.load_state_dict(state)
    b = _metrics(step(fresh, last))
    return {"continued": (a, _params(trainer)), "reloaded": (b, _params(fresh))}


def task_forced(spec, mesh, rank):
    """Each step from the JAX Trainer's state before it: the parent writes
    those states (`Trainer.state_dict()` form, full arrays) to
    spec["forced_path"] once its JAX run is done; this rank waits for the
    file, loads each state and takes that step on its rows."""
    from vae_teb_tpu_torch import Trainer, TrainerConfig
    from vae_teb_tpu_torch.parallel import shard_batch
    deadline = time.time() + spec["forced_wait_s"]
    while not os.path.exists(spec["forced_path"]):
        if time.time() > deadline:
            raise TimeoutError("the JAX states never came")
        time.sleep(0.2)
    states = torch.load(spec["forced_path"], weights_only=False)
    cfg = TrainerConfig(**spec["config"], prefetch=0)
    trainer = Trainer(_model(spec), cfg, device="cpu", mesh=mesh)
    out = []
    for state, batch, eps in zip(states, spec["batches"], spec["eps"]):
        trainer.load_state_dict(state)
        m = trainer.train_step(shard_batch(batch, mesh), spec["beta"],
                               eps=torch.tensor(eps))
        out.append((_metrics(m), _params(trainer)))
    return out


def task_early_stop(spec, mesh, rank):
    """fit with early stopping on batches that differ between ranks: the
    local losses differ, the decisions must not."""
    from vae_teb_tpu_torch import Trainer, TrainerConfig
    from vae_teb_tpu_torch.models import compute_loss
    cfg = TrainerConfig(**spec["config"], prefetch=0, early_stop_patience=1,
                        epochs=spec["early_stop"]["epochs"])
    trainer = Trainer(_model(spec), cfg, device="cpu", mesh=mesh)
    local = spec["early_stop"]["batches"][rank]
    with torch.no_grad():
        t = [torch.tensor(local[k]) for k in FIELDS]
        out = trainer.model.eval()(*t[:3], deterministic=True)
        own = compute_loss(out, *t[:2], t[3], beta=spec["beta"])
    logs = []
    trainer.fit(lambda epoch: iter([local]), log_fn=logs.append)
    return {"history": {k: v for k, v in trainer.history.items()
                        if k not in ("epoch_time", "windows_per_sec")},
            "logs": [line for line in logs if "early stop" in line],
            "own_loss": own["total_loss"].item()}


def task_checkpoint(spec, mesh, rank):
    """Rank 0 writes: a fit's checkpoint directory shared by the ranks, and
    each rank saving into a directory of its own; then every rank restores
    the shared checkpoint."""
    from vae_teb_tpu_torch import Trainer, TrainerConfig
    from vae_teb_tpu_torch.train import Checkpointer
    cfg = TrainerConfig(**spec["config"], prefetch=0, epochs=1)
    trainer = Trainer(_model(spec), cfg, device="cpu", mesh=mesh)
    shared = Checkpointer(spec["checkpoint"]["shared"])
    batch = spec["early_stop"]["batches"][rank]
    trainer.fit(lambda epoch: iter([batch]), checkpointer=shared,
                log_fn=lambda line: None)
    own = Checkpointer(os.path.join(spec["checkpoint"]["own"], f"r{rank}"))
    own.save(trainer.state_dict(), step=0, metric=1.0)
    dist.barrier()
    restored = Checkpointer(spec["checkpoint"]["shared"]).restore()
    return {"own_files": sorted(os.listdir(own.directory)),
            "restored": {k: v.numpy() for k, v in restored["model"].items()},
            "live": _params(trainer)}


def task_classifier(spec, mesh, rank):
    """ClassifierTrainer steps on this rank's rows (dropout and noise from
    the generator)."""
    from vae_teb_tpu_torch.models import SeqVaeTebClassifier
    from vae_teb_tpu_torch.parallel import shard_batch
    from vae_teb_tpu_torch.train import ClassifierConfig, ClassifierTrainer
    c = spec["classifier"]
    model = SeqVaeTebClassifier(**c["model"])
    model.load_state_dict(c["state"])
    trainer = ClassifierTrainer(model, ClassifierConfig(**c["config"]),
                                device="cpu", mesh=mesh)
    metrics = []
    for batch in c["batches"]:
        local = shard_batch(batch, mesh)
        metrics.append(_metrics(trainer.train_step(local, local["label"])))
    return {"metrics": metrics,
            "params": {k: v.detach().numpy().copy()
                       for k, v in trainer.model.state_dict().items()}}


TASKS = {"batch_norm": task_batch_norm, "noise": task_noise,
         "steps": task_steps, "resume": task_resume, "forced": task_forced,
         "early_stop": task_early_stop, "checkpoint": task_checkpoint,
         "classifier": task_classifier}


def run(rank, world, port, spec_path, out_dir):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from vae_teb_tpu_torch.parallel import (data_parallel_mesh, hybrid_mesh,
                                            init_distributed)
    init_distributed(device="cpu")
    spec = torch.load(spec_path, weights_only=False)
    n_model = spec.get("n_model", 1)
    mesh = (hybrid_mesh(world // n_model, n_model) if n_model > 1
            else data_parallel_mesh())
    results = {name: TASKS[name](spec, mesh, rank) for name in spec["tasks"]}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
