"""Classifier training: the InceptionTime head over SeqVaeTeb latents, and
the k-fold workflow.

Port of `vae_teb_tpu.train.classifier`: `ClassifierConfig`,
`ClassifierTrainer` (init_state with a pretrained VAE, train_step with CE
or LDAM, predict, fit) and `train_and_test_folds`. As in `Trainer`, the
state lives in the module, the optimizer and a `torch.Generator` on one
device (the card unless the caller names another). With a mesh the
trainer is one data-parallel rank, through `Trainer`'s machinery
(`train.distributed`): rank 0's weights, synced BatchNorm, the global
batch's noise and dropout masks, gradients and metrics averaged over the
data group. Every parameter stays replicated, as the JAX package's
classifier trainer replicates its state on any mesh.

The optimizer is the JAX chain clip_by_global_norm -> adamw
(`make_optimizer`), over every parameter of the wrapper, the frozen VAE's
included, as `optax.chain(clip_by_global_norm, adamw)` does over the whole
tree: a frozen parameter's gradient is zero, so its Adam direction is 0
and its update is the decay alone, -lr * weight_decay * p. `torch.optim`
optimizers skip a parameter with no gradient; `train_step` hands the
frozen ones zero gradients to keep optax's update (the reference froze
with requires_grad_(False), under which they do not move at all).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..init import init_parameters
from ..models.inception_time import SeqVaeTebClassifier
from ..models.variants import ldam_loss
from ..parallel.mesh import batch_sharding
from .checkpoint import transfer_params
from .distributed import MeshRunner
from .schedules import make_optimizer


@dataclass
class ClassifierConfig:
    """The JAX `ClassifierConfig`, field for field, with its defaults."""
    lr: float = 1e-4
    weight_decay: float = 1e-4
    grad_clip_norm: float = 1.0
    epochs: int = 20
    loss: str = "ce"                 # "ce" or "ldam"
    cls_num_list: Optional[Sequence[int]] = None  # needed for ldam
    ldam_max_m: float = 0.5
    ldam_s: float = 30.0
    vae_loss_weight: float = 0.0     # > 0 adds the VAE ELBO (reference 0.1)
    seed: int = 0


class ClassifierTrainer:
    """Train and predict steps, and the epoch loop, of a
    SeqVaeTebClassifier on one device: the CUDA card unless `device` names
    another (`device="cpu"`); the model moves there. With a `mesh`, one
    data-parallel rank (on the mesh's device unless `device` is given): a
    batch holds the rank's rows and the step is the global batch's."""

    def __init__(self, model: SeqVaeTebClassifier,
                 config: ClassifierConfig = ClassifierConfig(),
                 device=None, mesh=None):
        # joint fine-tuning (CE + w * ELBO with the VAE unfrozen): a
        # weighted VAE term against a frozen VAE would train nothing
        self.joint = config.vae_loss_weight > 0
        if self.joint and model.freeze_vae:
            raise ValueError(
                "vae_loss_weight > 0 requires SeqVaeTebClassifier("
                "freeze_vae=False): the joint mode fine-tunes the VAE")
        if config.loss not in ("ce", "ldam"):
            raise ValueError(f"unknown loss {config.loss!r}")
        if config.loss == "ldam" and config.cls_num_list is None:
            raise ValueError("ldam loss needs cls_num_list")
        self.model = model
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(
            device if device is not None or mesh is None else mesh.device)
        self.model.to(self.device)
        self.runner = None if mesh is None else MeshRunner(mesh, self.model)
        self.history: Dict[str, list] = {}
        self._reset()

    def _reset(self) -> None:
        """A fresh optimizer over the model's current weights, the
        generator seeded from the config, step 0."""
        cfg = self.config
        self.optimizer = make_optimizer(
            list(self.model.parameters()), cfg.lr, cfg.grad_clip_norm,
            cfg.weight_decay)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.step = 0

    def init_state(self, pretrained_vae: Optional[Mapping] = None
                   ) -> List[str]:
        """Initialize the wrapper from the config's seed, then copy a
        pretrained VAE's state_dict (parameters and BatchNorm statistics)
        into `vae_model`; fresh optimizer, generator and step count.
        (Without a call the trainer starts from the model's weights as
        given.) Returns the copied keys; raises when a pretrained VAE
        matches nothing."""
        init_parameters(self.model, self.config.seed)
        if self.runner:     # the same start on every rank
            self.runner = MeshRunner(self.mesh, self.model)
        copied: List[str] = []
        if pretrained_vae is not None:
            state, copied = transfer_params(
                pretrained_vae, self.model.state_dict(),
                dst_prefix=("vae_model",))
            if not copied:
                raise ValueError("no VAE parameters matched the wrapper")
            self.model.load_state_dict(state)
        self._reset()
        return copied

    def _tensors(self, batch: Mapping, keys) -> List[torch.Tensor]:
        return [torch.as_tensor(batch[k], dtype=torch.float32,
                                device=self.device) for k in keys]

    def _labels(self, batch: Mapping, labels) -> torch.Tensor:
        lab = batch["label"] if labels is None else labels
        return torch.as_tensor(lab, device=self.device).long()

    def train_step(self, batch: Mapping, labels=None,
                   eps: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step on `batch` (fhr_st, fhr_ph, fhr_up_ph, and fhr in joint
        mode), with `labels` or batch["label"]: train-mode forward with z
        sampled from the trainer's generator (or the caller's eps) and the
        head's dropout from it too, the loss (CE or LDAM, + w * ELBO in
        joint mode), backward and the clipped AdamW update of every
        parameter. Returns 0-dim device tensors: loss, accuracy,
        classification_loss (and vae_loss in joint mode)."""
        cfg = self.config
        y_st, y_ph, x_ph = self._tensors(batch, ("fhr_st", "fhr_ph",
                                                 "fhr_up_ph"))
        lab = self._labels(batch, labels)
        y_raw = self._tensors(batch, ("fhr",))[0] if self.joint else None
        runner = self.runner
        with (runner.noise() if runner else contextlib.nullcontext()):
            out = self.model.train()(y_st, y_ph, x_ph,
                                     generator=self.generator, eps=eps)
        losses = SeqVaeTebClassifier.compute_loss(
            out, lab, y_st=y_st, y_ph=y_ph, y_raw=y_raw,
            compute_vae_loss=self.joint, vae_loss_weight=cfg.vae_loss_weight)
        if cfg.loss == "ldam":   # swaps the CE term only
            cls = ldam_loss(out["logits"], lab, tuple(cfg.cls_num_list),
                            cfg.ldam_max_m, cfg.ldam_s)
            losses["classification_loss"] = cls
            losses["total_loss"] = cls + cfg.vae_loss_weight * losses[
                "vae_loss"]
        self.optimizer.zero_grad(set_to_none=False)
        losses["total_loss"].backward()
        for p in self.model.parameters():   # the frozen VAE: zero, as optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if runner:
            runner.reduce_grads(list(self.model.parameters()))
        self.optimizer.step()
        self.step += 1
        metrics = {"loss": losses["total_loss"].detach(),
                   "accuracy": (out["predictions"] == lab).float().mean(),
                   "classification_loss":
                       losses["classification_loss"].detach()}
        if self.joint:
            metrics["vae_loss"] = losses["vae_loss"].detach()
        return runner.mean(metrics) if runner else metrics

    @torch.inference_mode()
    def predict(self, batch: Mapping):
        """(logits, probabilities) as numpy: eval mode, z = the posterior
        mean."""
        y_st, y_ph, x_ph = self._tensors(batch, ("fhr_st", "fhr_ph",
                                                 "fhr_up_ph"))
        out = self.model.eval()(y_st, y_ph, x_ph, deterministic_latent=True)
        return (out["logits"].float().cpu().numpy(),
                out["probabilities"].float().cpu().numpy())

    def fit(self, train_batches: Callable[[int], Iterator],
            label_fn: Callable[[dict], np.ndarray],
            epochs: Optional[int] = None,
            log_fn: Callable[[str], None] = print) -> Dict[str, list]:
        """Epochs of train steps (train_batches(epoch) yields the batches,
        label_fn(batch) their labels); per epoch the mean of each metric
        goes to the history (train/<metric>) and one log line. Returns the
        history."""
        for epoch in range(epochs or self.config.epochs):
            t0 = time.time()
            metrics = [self.train_step(batch, label_fn(batch))
                       for batch in train_batches(epoch)]
            avg = ({k: float(torch.stack([m[k] for m in metrics]).mean())
                    for k in metrics[0]} if metrics else {})
            for k, v in avg.items():
                self.history.setdefault(f"train/{k}", []).append(v)
            log_fn(f"classifier epoch {epoch}: loss "
                   f"{avg.get('loss', float('nan')):.4f} acc "
                   f"{avg.get('accuracy', float('nan')):.3f} "
                   f"({time.time() - t0:.1f}s)")
        return self.history


def train_and_test_folds(make_model: Callable[[], SeqVaeTebClassifier],
                         dataset, folds: Dict, label_fn,
                         config: ClassifierConfig = ClassifierConfig(),
                         batch_size: int = 8, device=None,
                         pretrained_vae: Optional[Mapping] = None,
                         log_fn: Callable[[str], None] = print,
                         mesh=None) -> Dict:
    """The k-fold classifier workflow: per fold, a fresh trainer on the
    train GUIDs' windows, then the test windows' probabilities.

    dataset: len(), dataset[i]["guid"] and dataset.collate(indices) -> a
    batch; folds: `data.splits.create_cv_splits` over GUID groups;
    label_fn(batch) -> integer labels. A fold without train or test
    windows is skipped. With a `mesh` each fold trains data-parallel: the
    rank takes its rows of every batch of `batch_size` (a multiple of the
    data axis) and predicts the whole test set. Returns {fold: {probabilities, labels,
    test_indices}} for `eval.classification.aggregate_fold_results`.
    """
    results = {}
    for fold_name, split in folds.items():
        train_guids = {g for group in split["train"].values() for g in group}
        test_guids = {g for group in split["test"].values() for g in group}
        train_idx = [i for i in range(len(dataset))
                     if dataset[i]["guid"] in train_guids]
        test_idx = [i for i in range(len(dataset))
                    if dataset[i]["guid"] in test_guids]
        if not train_idx or not test_idx:
            continue
        trainer = ClassifierTrainer(make_model(), config, device=device,
                                    mesh=mesh)
        trainer.init_state(pretrained_vae)
        rows = (slice(None) if mesh is None else
                batch_sharding(mesh).block(batch_size))

        def batches(epoch, idx=tuple(train_idx)):
            order = np.random.default_rng(epoch).permutation(len(idx))
            for start in range(0, len(order) - batch_size + 1, batch_size):
                chunk = order[start:start + batch_size][rows]
                yield dataset.collate([idx[j] for j in chunk])

        trainer.fit(batches, label_fn, log_fn=log_fn)
        probs_all, labels_all = [], []
        for start in range(0, len(test_idx), batch_size):
            batch = dataset.collate(test_idx[start:start + batch_size])
            probs_all.append(trainer.predict(batch)[1])
            labels_all.append(label_fn(batch))
        results[fold_name] = {
            "probabilities": np.concatenate(probs_all),
            "labels": np.concatenate(labels_all),
            "test_indices": np.asarray(test_idx),
        }
        log_fn(f"{fold_name}: {len(train_idx)} train / {len(test_idx)} test")
    return results
