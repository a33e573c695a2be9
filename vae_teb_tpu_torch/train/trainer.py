"""The training step and loop of SeqVaeTeb and its families.

Port of `vae_teb_tpu.train.trainer`: `TrainerConfig`, `Trainer.train_step`
/ `eval_step` (forward, ELBO, backward, clipped AdamW) and `Trainer.fit`
(epochs, per-epoch beta, history, early stopping, checkpoints, callbacks,
prefetch). PyTorch keeps the training state where the JAX package threads
a `TrainState` through a jitted function: the parameters and BatchNorm
statistics live in the module, the Adam moments and update count in the
optimizer, the sampling noise comes from a `torch.Generator`, and the step
count is `Trainer.step`, all on one explicit device. Each step updates
them in place; `state_dict()` / `load_state_dict()` save and restore all
of them (`train.checkpoint.Checkpointer`).

Multi-device training: `Trainer(mesh=...)` with a mesh of
`parallel.data_parallel_mesh()` or `parallel.hybrid_mesh(n_data, n_model)`,
one process a device (torchrun's ranks, `parallel.init_distributed`). Each
rank steps on its rows of the global batch; BatchNorm statistics, noise,
gradients and metrics are the global batch's, and on a 'model' axis the
wide decoder-head weights and their Adam moments are sharded by
`tp_min_dim` (`train.distributed`). `mesh=None` is the one-device trainer,
unchanged.

K steps per execution (`TrainerConfig.steps_per_execution`,
`train_multi_step`): the JAX package scans the step over a (K, B, ...)
stack in one dispatch. On the card the port replays a CUDA graph of the
step K times (`train.graphs`): the first steps of each batch shape (and
accumulation micro-step) run eagerly, as steps and as the graph's
warm-up, and the graph is captured after them; every later step of that
shape is a replay, whose result is the eager step's. On the CPU a group
is a loop of `train_step`. Under a mesh `fit` steps one batch at a time,
as the JAX package does in a multi-process run.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import (Callable, Dict, Iterable, Iterator, Mapping, Optional,
                    Sequence)

import numpy as np
import torch

from ..device import resolve_device
from ..models.vae_teb import SeqVaeTeb
from ..utils import profiling
from .distributed import MeshRunner
from .graphs import StepGraph, capture_step, flat_rows
from .schedules import (ClippedAdamW, MultiSteps, beta_schedule,
                        cosine_warm_restarts, global_norm, make_optimizer)

FIELDS = ("fhr_st", "fhr_ph", "fhr_up_ph", "fhr")   # y_st, y_ph, x_ph, y_raw


@dataclass
class TrainerConfig:
    """The JAX `TrainerConfig`, field for field, with the same defaults,
    but for two fields that have no counterpart: `donate_state` (PyTorch
    updates the parameters and moments in place, which is what donation
    buys the JAX package) and `log_every` (read nowhere in the JAX package;
    `fit` logs once per epoch). `load_config` skips both in a config
    file."""
    lr: float = 1e-4
    grad_clip_norm: float = 0.5
    weight_decay: float = 1e-4
    epochs: int = 50
    kld_beta: float = 1e-5           # reference config.yaml kld_beta
    beta_schedule: str = "constant"
    beta_start: float = 0.0
    beta_end: float = 1.0
    beta_anneal_epochs: int = 100
    beta_cycle_len: int = 1000
    lr_t0_steps: int = 0             # 0 => constant lr
    early_stop_patience: int = 0     # 0 => disabled
    seed: int = 42
    # compute precision policy: "fp32" or "bf16" (parameters always fp32)
    precision: str = "fp32"
    # average gradients over k micro-batches before one optimizer step
    accumulate_grad_batches: int = 1
    # Adam moment storage: "fp32" or "bf16"
    moment_dtype: str = "fp32"
    # tensor-parallel threshold on a hybrid ('data', 'model') mesh: Dense
    # weights with output dim >= tp_min_dim shard over 'model'
    # (parallel.tensor_parallel_rule); read only when the mesh has a
    # 'model' axis of size > 1
    tp_min_dim: int = 2048
    # batches staged onto the device ahead of the step (0 disables)
    prefetch: int = 2
    # train steps per execution: fit groups K batches of one shape into
    # one train_multi_step (a CUDA graph replayed K times on the card)
    steps_per_execution: int = 1

    def model_dtype(self) -> Optional[torch.dtype]:
        """The model's compute dtype: torch.bfloat16 for "bf16", None (the
        float32 path) for "fp32"."""
        if self.precision == "bf16":
            return torch.bfloat16
        if self.precision in ("fp32", "float32"):
            return None
        raise ValueError(f"unknown precision: {self.precision!r}")

    def moment_torch_dtype(self) -> Optional[torch.dtype]:
        if self.moment_dtype == "bf16":
            return torch.bfloat16
        if self.moment_dtype in ("fp32", "float32"):
            return None
        raise ValueError(f"unknown moment_dtype: {self.moment_dtype!r}")


def _groups(batches: Iterable[Mapping], k: int) -> Iterator[list]:
    """Consecutive batches in lists of up to k whose fields have one shape
    each: a batch of another shape closes the list early (the JAX
    package's `_stack_batches` stacks k whatever their shapes)."""
    group, shapes = [], None
    for b in batches:
        s = tuple(tuple(b[f].shape) for f in FIELDS)
        if group and (s != shapes or len(group) == k):
            yield group
            group = []
        group.append(b)
        shapes = s
    if group:
        yield group


class Trainer:
    """Train and eval steps, and the epoch loop, for a SeqVaeTeb on one
    device: the CUDA card unless `device` names another (`device="cpu"`);
    the model moves there. Any family of `models` trains here (SeqVaeTeb,
    `SeqVaeTebForecast`, `SeqVaeTebPredictSt`): the steps take the loss
    from the model (`model.loss(outputs, y_st, y_ph, y_raw, beta)`), and
    the metrics they return are that loss's terms.

    With a `mesh` (`parallel.data_parallel_mesh` / `hybrid_mesh`) the
    trainer is one rank of a data- or tensor-parallel run, on the mesh's
    device unless `device` is given: a batch holds the rank's rows of the
    global batch (`parallel.shard_batch`; the loaders' shard_index /
    shard_count), a caller's `eps` is the global batch's, and every rank
    computes the global batch's step (see `train.distributed`).

    The model's compute dtype must be the config's (`SeqVaeTeb(dtype=
    config.model_dtype())`). `optimizer`, the counterpart of the JAX
    package's `tx=`, builds the optimizer from the parameter list (default:
    `make_optimizer` with the config's lr schedule, clip, decay and moment
    dtype); with accumulate_grad_batches = k > 1 it is wrapped in
    `MultiSteps(..., k)`.

    `normalize_stats` ({field: FieldStats}): batches then arrive raw, the
    multichannel fields in on-disk (B, C, S) layout, and each step
    normalizes them on the device and swaps them to (B, S, C) (`_prep`).
    Otherwise a batch holds fhr_st (B, S, 43), fhr_ph (B, S, 44), fhr_up_ph
    (B, S, 130) and the raw target fhr (B, 16 S), as arrays or tensors.

    With steps_per_execution > 1 on the card the step is captured as a
    CUDA graph (`train_multi_step`), so the optimizer must be one whose
    step reads no host value that changes between steps: the default
    (`ClippedAdamW`), or a torch.optim optimizer built with
    capturable=True; any other raises here.
    """

    def __init__(self, model: SeqVaeTeb, config: TrainerConfig = TrainerConfig(),
                 device=None,
                 optimizer: Optional[Callable[[Iterable[torch.Tensor]],
                                              torch.optim.Optimizer]] = None,
                 normalize_stats: Optional[Mapping] = None, mesh=None):
        dtype = config.model_dtype()                 # raises if unknown
        moment_dtype = config.moment_torch_dtype()   # raises if unknown
        if getattr(model, "dtype", None) != dtype:
            raise ValueError(f"precision={config.precision!r} needs a model "
                             f"with dtype={dtype}, got "
                             f"{getattr(model, 'dtype', None)}")
        if config.steps_per_execution < 1:
            raise ValueError(f"steps_per_execution must be >= 1, got "
                             f"{config.steps_per_execution}")
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(
            device if device is not None or mesh is None else mesh.device)
        self.model = model.to(self.device)
        self.normalize_stats = normalize_stats
        self.runner = (None if mesh is None else
                       MeshRunner(mesh, self.model, config.tp_min_dim))
        sharded = [] if mesh is None else self.runner.sharded_params
        params = list(self.model.parameters())
        if optimizer is None:
            lr = (cosine_warm_restarts(config.lr, config.lr_t0_steps)
                  if config.lr_t0_steps > 0 else config.lr)
            self.optimizer = make_optimizer(
                params, lr, config.grad_clip_norm, config.weight_decay,
                moment_dtype=moment_dtype, sharded=sharded,
                model_group=None if mesh is None else self.runner.model_group)
        elif sharded:
            raise ValueError("a sharded model needs the default optimizer, "
                             "whose clip norm sums the shards")
        else:
            self.optimizer = optimizer(params)
        if config.accumulate_grad_batches > 1:
            self.optimizer = MultiSteps(self.optimizer,
                                        config.accumulate_grad_batches)
        if config.steps_per_execution > 1:
            self._check_capturable()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.step = 0            # train steps taken (micro-steps included)
        # the loss's KLD weight, read by the step on the device
        self._beta = torch.zeros((), dtype=torch.float32, device=self.device)
        self._normalizers: Dict[tuple, Callable] = {}
        # captured steps by (field shapes, eps given, micro-step), sharing
        # one memory pool
        self.graphs: Dict[tuple, StepGraph] = {}
        self._pool = None
        # whether train_multi_step replays graphs (on the card) or loops
        # train_step
        self.captures = self.device.type == "cuda"
        # per-epoch KLD weight
        self.beta_fn = beta_schedule(config.beta_schedule, config.beta_start,
                                     config.beta_end, config.beta_anneal_epochs,
                                     config.beta_cycle_len, config.kld_beta)
        self.history: Dict[str, list] = {}

    # -- steps ---------------------------------------------------------------

    def _batch(self, batch: Mapping):
        return tuple(torch.as_tensor(batch[k], dtype=torch.float32,
                                     device=self.device) for k in FIELDS)

    def _prep(self, y_st, y_ph, x_ph, y_raw):
        """Identity unless normalize_stats is set; then the raw (B, C, S)
        fields are normalized (`data.normalize.normalize_field`'s
        arithmetic, with the statistics copied to the device at the first
        batch of each shape) and swapped to (B, S, C), and fhr is z-scored,
        on the device."""
        st = self.normalize_stats
        if st is None:
            return y_st, y_ph, x_ph, y_raw
        from ..data.normalize import field_normalizer

        def norm(x, name, channel_axis):
            key = (name, x.shape[channel_axis], x.ndim, x.dtype, x.device)
            if key not in self._normalizers:   # usable where autograd records
                with torch.inference_mode(False):
                    self._normalizers[key] = field_normalizer(
                        name, st[name], x, channel_axis)
            return self._normalizers[key](x)

        def mc(x, name):
            if name in st:
                x = norm(x, name, -2)
            return x.transpose(1, 2)

        if "fhr" in st:
            y_raw = norm(y_raw, "fhr", -1)
        return (mc(y_st, "fhr_st"), mc(y_ph, "fhr_ph"),
                mc(x_ph, "fhr_up_ph"), y_raw)

    def train_step(self, batch: Mapping, beta: float,
                   eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One train step on `batch`, in place: the module's parameters and
        BatchNorm running statistics, the optimizer's state, the
        generator's state and `step` all advance (under accumulation the
        parameters and moments move on every k-th step only).

        The forward runs in training mode (batch statistics) with z sampled
        from `self.generator`, or from the caller's standard-normal `eps`
        (B, S, latent) when given. Returns 0-dim device tensors: the terms
        of the model's loss (SeqVaeTeb's four losses and total_loss), and
        grad_norm, the global norm of this step's gradient before
        clipping.
        """
        self._beta.fill_(beta)
        with profiling.span("trainer.eager_step"):
            metrics = self._step(*self._batch(batch), eps)
        self.step += 1
        return metrics

    def _step(self, y_st, y_ph, x_ph, y_raw, eps=None
              ) -> Dict[str, torch.Tensor]:
        """The step's device work on the fields as tensors (the body that
        `train.graphs.capture_step` records): everything `train_step` does
        but count the step. Its stage marks (`utils.profiling`): a start,
        the model's `encode` and `decode` (and whatever marks its decoder
        sets between them), `decode` again after the loss,
        `decode_backward`, `encode_backward` at the end of the backward, and
        `optimizer`."""
        with profiling.stages("step", self.device):
            y_st, y_ph, x_ph, y_raw = self._prep(y_st, y_ph, x_ph, y_raw)
            model = self.model.train()
            runner = self.runner
            with (runner.noise() if runner else contextlib.nullcontext()):
                out = model(y_st, y_ph, x_ph, deterministic=False,
                            generator=self.generator, eps=eps)
            losses = model.loss(out, y_st, y_ph, y_raw, self._beta)
            profiling.mark("decode")
            self.optimizer.zero_grad(set_to_none=True)
            losses["total_loss"].backward()
            profiling.mark("encode_backward")
            if runner:
                runner.reduce_grads(list(self.model.parameters()))
            grad_norm = self.optimizer.step()
            if grad_norm is None:   # a torch.optim optimizer returns no norm
                grad_norm = global_norm([p.grad
                                         for p in self.model.parameters()
                                         if p.grad is not None])
            profiling.mark("optimizer")
        metrics = {k: v.detach() for k, v in losses.items()}
        if runner:
            metrics = runner.mean(metrics)
        metrics["grad_norm"] = grad_norm
        return metrics

    def _check_capturable(self) -> None:
        """Raise unless a CUDA graph of the step can replay the optimizer:
        `ClippedAdamW` or a torch.optim optimizer with capturable=True.
        Checked on the card only: on the CPU nothing is captured."""
        inner = getattr(self.optimizer, "inner", self.optimizer)
        if (self.device.type == "cuda" and not isinstance(inner, ClippedAdamW)
                and not inner.defaults.get("capturable", False)):
            raise ValueError(
                f"steps_per_execution > 1 captures the train step as a CUDA "
                f"graph, and the optimizer {type(inner).__name__} was not "
                f"built with capturable=True: its step reads host values a "
                f"replay would freeze")

    def train_multi_step(self, stacked_batch: Mapping, beta: float,
                         eps: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
        """K = leading-axis train steps in one execution: the JAX package's
        `train_multi_step`. `stacked_batch` holds (K, B, ...) stacks of K
        consecutive batches (`np.stack` of what `train_step` takes), `eps`
        (K, B, S, latent) if given. Returns each metric as a (K,) device
        tensor; every state advances as K `train_step` calls would advance
        it, `step` by K.

        On the CPU this is a loop of `train_step`. On the card each step is
        a replay of the step's CUDA graph for its field shapes, whether
        eps is given and the accumulation micro-step: a step whose graph
        does not exist yet runs eagerly (the warm-up), and the graph is
        captured after the group, so the next group replays it. A replay
        computes what the eager step computes, and its kernel launches are
        counted as theirs. Raises under a mesh (`fit` steps one batch at a
        time there) and for an optimizer a graph cannot replay.

        Spans (`utils.profiling`): `trainer.train_multi_step` over the
        call, and inside it `trainer.eager_step`, `trainer.replay` (copy
        in, launch, copy out; the launch itself `graph.launch`) and
        `trainer.capture`."""
        with profiling.span("trainer.train_multi_step"):
            if self.runner is not None:
                raise ValueError("train_multi_step steps one device: under a "
                                 "mesh fit takes one batch at a time")
            fields = [torch.as_tensor(stacked_batch[k], dtype=torch.float32,
                                      device=self.device) for k in FIELDS]
            K = fields[0].shape[0]
            if any(f.shape[0] != K for f in fields) or (
                    eps is not None and eps.shape[0] != K):
                raise ValueError("stacked fields and eps need one leading K")
            if not self.captures:
                steps = [self.train_step(
                    {k: f[i] for k, f in zip(FIELDS, fields)}, beta,
                    None if eps is None else eps[i]) for i in range(K)]
                return {k: torch.stack([m[k] for m in steps])
                        for k in steps[0]}
            self._check_capturable()
            self._beta.fill_(beta)
            if eps is not None:
                fields.append(torch.as_tensor(eps, dtype=torch.float32,
                                              device=self.device))
            shapes = tuple(tuple(f.shape[1:]) for f in fields)
            rows = flat_rows(fields)
            out, pending = [], []
            for i in range(K):
                key = (shapes, self._micro_step())
                graph = self.graphs.get(key)
                if graph is None:
                    with profiling.span("trainer.eager_step"):
                        metrics = self._step(*(f[i] for f in fields))
                    names = list(metrics)
                    out.append(torch.stack([metrics[k].float()
                                            for k in names]))
                    pending.append(key)
                else:
                    with profiling.span("trainer.replay"):
                        out.append(graph.replay(rows[i]))
                    names = graph.metrics
                    if isinstance(self.optimizer, MultiSteps):
                        self.optimizer.advance()
                self.step += 1
            for key in dict.fromkeys(pending):   # capture runs nothing: the
                self._capture(key, shapes)       # next group replays it
            out = torch.stack(out)
            return {k: out[:, j] for j, k in enumerate(names)}

    def _micro_step(self) -> int:
        return getattr(self.optimizer, "mini_step", 0)

    def _capture(self, key: tuple, shapes) -> None:
        """Capture the step for `key` = (shapes, micro-step) into the
        trainer's shared memory pool, with the accumulation's micro-step
        set to the key's and restored after."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        micro = self._micro_step()
        if isinstance(self.optimizer, MultiSteps):
            self.optimizer.mini_step = key[1]
        try:
            with profiling.span("trainer.capture"):
                self.graphs[key] = capture_step(
                    self._step, shapes, self.generator, self._pool,
                    self.device)
        finally:
            if isinstance(self.optimizer, MultiSteps):
                self.optimizer.mini_step = micro

    @torch.no_grad()
    def eval_step(self, batch: Mapping, beta: float) -> Dict[str, torch.Tensor]:
        """The deterministic forward (posterior mean, running statistics)
        and its losses, over the data group's rows under a mesh; changes
        no state."""
        y_st, y_ph, x_ph, y_raw = self._prep(*self._batch(batch))
        model = self.model.eval()
        out = model(y_st, y_ph, x_ph, deterministic=True)
        losses = model.loss(out, y_st, y_ph, y_raw, beta)
        return self.runner.mean(losses) if self.runner else losses

    # -- state ---------------------------------------------------------------

    def state_dict(self) -> Dict:
        """Everything a resumed run needs to continue exactly: the model's
        parameters and BatchNorm statistics, the optimizer's state (moments
        in their storage dtype, the update count, accumulated gradients),
        the generator's state and the step count. Under tensor parallelism
        the sharded weights and their moments are gathered whole (every
        rank must call it), so the state loads under any layout."""
        model_state = self.model.state_dict()
        optimizer_state = self.optimizer.state_dict()
        if self.runner and self.runner.sharded:
            model_state, optimizer_state = self.runner.full_state(
                model_state, optimizer_state)
        return {"model": model_state, "optimizer": optimizer_state,
                "generator": self.generator.get_state(),
                "step": self.step}

    def load_state_dict(self, state: Mapping) -> None:
        """Restore a `state_dict()` (full arrays; a tensor-parallel rank
        keeps its rows of the sharded ones)."""
        model_state, optimizer_state = state["model"], state["optimizer"]
        if self.runner and self.runner.sharded:
            model_state, optimizer_state = self.runner.local_state(
                model_state, optimizer_state)
        self.model.load_state_dict(model_state)
        self.optimizer.load_state_dict(optimizer_state)
        self.generator.set_state(state["generator"])
        self.step = int(state["step"])
        self.graphs.clear()   # they hold the replaced moments' memory

    # -- loop ----------------------------------------------------------------

    @staticmethod
    def _mean(metrics: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, float]:
        """Per key, the mean over steps, each step weighing the same whether
        it came alone (a 0-dim tensor) or in a group ((K,)); one
        device-to-host copy a key."""
        if not metrics:
            return {}
        return {k: float(np.mean(torch.cat([m[k].reshape(-1) for m in metrics])
                                 .float().cpu().numpy()))
                for k in metrics[0]}

    def fit(self, train_batches: Callable[[int], Iterator],
            val_batches: Optional[Callable[[int], Iterator]] = None,
            epochs: Optional[int] = None, checkpointer=None,
            log_fn: Callable[[str], None] = print,
            callbacks: Sequence = (), start_epoch: int = 0
            ) -> Dict[str, list]:
        """Run epochs [start_epoch, epochs or config.epochs).

        train_batches / val_batches: epoch index -> batch iterator (so each
        epoch can reshuffle). Per epoch: beta from the schedule, train steps
        (batches staged `config.prefetch` ahead onto the device; with
        steps_per_execution = K > 1, groups of up to K consecutive batches
        of one shape through `train_multi_step`, a batch of another shape
        closing a group early; under a mesh one batch at a time, logged
        once), the validation means, history entries (epoch, beta,
        epoch_time, windows_per_sec, train/<metric> as the mean over
        steps, val/<metric>) and one log line.
        The monitored metric is the validation total_loss, else the train
        one; `checkpointer.save(self.state_dict(), step=epoch,
        metric=monitored)` keeps the best (on rank 0: under a mesh every
        rank agrees on the metrics); training stops after
        `early_stop_patience` epochs without improvement (0: never).
        callbacks: objects with on_epoch_end(trainer, epoch) and
        on_fit_end(trainer); an exception in one is logged, never fatal.
        Returns the history.
        """
        cfg = self.config
        best_val = float("inf")
        bad_epochs = 0
        spe = cfg.steps_per_execution
        if spe > 1 and self.runner is not None:
            log_fn(f"steps_per_execution={spe} is not used under a mesh: "
                   f"one train step per batch")
            spe = 1
        for epoch in range(start_epoch,
                           epochs if epochs is not None else cfg.epochs):
            beta = self.beta_fn(epoch)
            t0 = time.time()
            train_metrics = []
            n_windows = 0
            batches = train_batches(epoch)
            if cfg.prefetch > 0:
                from ..data.dataset import prefetch_to_device
                batches = prefetch_to_device(batches, size=cfg.prefetch,
                                             device=self.device,
                                             array_fields=FIELDS)
            rows = self.runner.n_data if self.runner else 1
            for group in _groups(batches, spe):
                n_windows += rows * sum(int(b["fhr"].shape[0]) for b in group)
                if spe == 1:
                    train_metrics.append(self.train_step(group[0], beta))
                else:
                    train_metrics.append(self.train_multi_step(
                        {k: torch.stack([torch.as_tensor(
                            b[k], dtype=torch.float32, device=self.device)
                            for b in group]) for k in FIELDS}, beta))
            train_avg = self._mean(train_metrics)
            epoch_time = time.time() - t0
            win_rate = n_windows / epoch_time if epoch_time > 0 else 0.0

            val_avg = {}
            if val_batches is not None:
                val_avg = self._mean([self.eval_step(b, beta)
                                      for b in val_batches(epoch)])

            self.history.setdefault("epoch", []).append(epoch)
            self.history.setdefault("beta", []).append(beta)
            self.history.setdefault("epoch_time", []).append(epoch_time)
            self.history.setdefault("windows_per_sec", []).append(win_rate)
            for k, v in train_avg.items():
                self.history.setdefault(f"train/{k}", []).append(v)
            for k, v in val_avg.items():
                self.history.setdefault(f"val/{k}", []).append(v)

            log_fn(f"epoch {epoch}: "
                   f"train {train_avg.get('total_loss', float('nan')):.4f} "
                   f"val {val_avg.get('total_loss', float('nan')):.4f} "
                   f"beta {beta:.2e} ({epoch_time:.1f}s, "
                   f"{win_rate:.0f} win/s)")

            monitored = val_avg.get("total_loss",
                                    train_avg.get("total_loss", float("inf")))
            if checkpointer is not None:   # state_dict(): a collective
                checkpointer.save(self.state_dict(), step=epoch,
                                  metric=monitored)
            for cb in callbacks:
                try:
                    cb.on_epoch_end(self, epoch)
                except Exception as e:  # plots must never kill training
                    log_fn(f"callback {type(cb).__name__} failed at epoch "
                           f"{epoch}: {e!r}")
            if monitored < best_val - 1e-12:
                best_val = monitored
                bad_epochs = 0
            else:
                bad_epochs += 1
                if (cfg.early_stop_patience
                        and bad_epochs >= cfg.early_stop_patience):
                    log_fn(f"early stop at epoch {epoch} "
                           f"(no improvement for {bad_epochs} epochs)")
                    break
        for cb in callbacks:
            try:
                cb.on_fit_end(self)
            except Exception as e:
                log_fn(f"callback {type(cb).__name__} on_fit_end failed: "
                       f"{e!r}")
        return self.history
