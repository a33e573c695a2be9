"""Typed run configuration, loaded from and saved to YAML.

Port of `vae_teb_tpu.train.config`: the same dataclasses, fields and
defaults, over the port's `TrainerConfig`, so a config file of the JAX
package loads unchanged. `yaml` is imported inside `load_config` and
`save_config`; without PyYAML a `RunConfig` is built in code.

`ModelConfig.family` is the port's own: the model family `cli train`
builds, SeqVaeTeb by default.
`ModelConfig.lstm_schedule` is read, but the port has one LSTM schedule:
"stacked", "wavefront" and "wavefront_pallas" all run the wavefront CUDA
kernels (the same staircase recurrence as the JAX package's wavefront
schedules; "stacked" computes the same function in another order).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .trainer import TrainerConfig

LSTM_SCHEDULES = ("stacked", "wavefront", "wavefront_pallas")


MODEL_FAMILIES = ("seqvae_teb", "seqvae_teb_forecast")


@dataclass
class ModelConfig:
    # which model `cli train` builds: one of MODEL_FAMILIES (SeqVaeTeb, or
    # SeqVaeTebForecast with its published direct decoder)
    family: str = "seqvae_teb"
    latent_dim_source: int = 32
    latent_dim_target: int = 32
    latent_dim_z: int = 32
    input_channels: int = 130
    n_scattering: int = 43
    n_phase: int = 44
    decimation_factor: int = 16
    warmup_period: int = 30
    freeze_vae: bool = True
    zero_source: bool = False
    # one of LSTM_SCHEDULES; all run the wavefront kernels
    lstm_schedule: str = "wavefront"


@dataclass
class DatasetConfig:
    train_paths: List[str] = field(default_factory=list)
    validation_paths: List[str] = field(default_factory=list)
    test_paths: List[str] = field(default_factory=list)
    stat_path: Optional[str] = None
    normalize_fields: Optional[List[str]] = None
    trim_minutes: Optional[float] = 2.0
    decimation: int = 16  # raw-to-sequence ratio (T), for trim arithmetic
    cache_size: int = 2000
    batch_size: int = 2
    eval_batch_size: int = 4


@dataclass
class CheckpointConfig:
    base_model_checkpoint: Optional[str] = None
    classification_checkpoint: Optional[str] = None
    test_checkpoint_path: Optional[str] = None
    keep: int = 2


@dataclass
class RunConfig:
    tag: str = "run"
    out_dir_base: str = "runs"
    train_model: bool = True
    test_model: bool = False
    model: ModelConfig = field(default_factory=ModelConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    checkpoints: CheckpointConfig = field(default_factory=CheckpointConfig)

    def run_dir(self, create: bool = True) -> str:
        """out_dir_base/<date>-<tag>, with its train_results, test_results
        and model_checkpoints subdirectories."""
        stamp = datetime.date.today().isoformat()
        path = os.path.join(self.out_dir_base, f"{stamp}-{self.tag}")
        if create:
            for sub in ("train_results", "test_results", "model_checkpoints"):
                os.makedirs(os.path.join(path, sub), exist_ok=True)
        return path


_NESTED = {"ModelConfig": ModelConfig, "TrainerConfig": TrainerConfig,
           "DatasetConfig": DatasetConfig, "CheckpointConfig": CheckpointConfig}


def _build(cls, data: Optional[Dict]):
    """Recursively build a dataclass from a dict, ignoring unknown keys.
    Field types are string annotations (PEP 563), so nested configs are
    resolved by name."""
    if data is None:
        return cls()
    names = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in names:
            continue
        ftype = names[key].type
        ftype_name = ftype if isinstance(ftype, str) else getattr(
            ftype, "__name__", "")
        if ftype_name in _NESTED:
            kwargs[key] = _build(_NESTED[ftype_name], value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def load_config(path: str, root: Optional[str] = None) -> RunConfig:
    """Load a RunConfig from YAML; resolve relative dataset paths and
    out_dir_base against `root`."""
    import yaml
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = _build(RunConfig, raw)
    if root:
        ds = cfg.dataset
        for attr in ("train_paths", "validation_paths", "test_paths"):
            setattr(ds, attr, [p if os.path.isabs(p) else os.path.join(root, p)
                               for p in getattr(ds, attr)])
        if ds.stat_path and not os.path.isabs(ds.stat_path):
            ds.stat_path = os.path.join(root, ds.stat_path)
        if not os.path.isabs(cfg.out_dir_base):
            cfg.out_dir_base = os.path.join(root, cfg.out_dir_base)
    return cfg


def save_config(cfg: RunConfig, path: str) -> None:
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)
