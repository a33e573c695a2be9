"""Command-line entry point of the port: train, build-data, stats, pack-data.

    python -m vae_teb_tpu_torch.cli train --config configs/default.yaml \
        [--root DIR] [--resume [CKPT_DIR]] [--device-normalize] [--device cpu]
    python -m vae_teb_tpu_torch.cli build-data --out data.h5 \
        [--records 16 --windows 8 --seed 0] [--stats-out stats.h5] [--device cpu]
    python -m vae_teb_tpu_torch.cli stats --data data.h5 --out stats.h5
    python -m vae_teb_tpu_torch.cli pack-data --data data.h5 --out DIR \
        [--stats stats.h5 | --raw]

Port of the `train`, `build-data`, `stats` and `pack-data` subcommands of
`vae_teb_tpu.cli`, with the same flags and defaults. `train` and
`build-data` run on the CUDA card unless `--device` names another; `stats`
and `pack-data` are host passes over HDF5 files (h5py). `test` and
`export` wait for their slices of the port.

`cmd_train` reads the YAML config (and, with --device-normalize, the
statistics file) and calls `run_training`, which a program may call
directly with a `RunConfig` built in code: on a machine without PyYAML or
h5py, with train and validation paths that are packed window stores and
normalization statistics given as `FieldStats`.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
from typing import Mapping, Optional, Union

from .device import resolve_device


def make_model(cfg, seq_len: int):
    """SeqVaeTeb from `cfg.model` at the config's precision, for sequences
    of `seq_len` steps (the port sizes the decoder heads at construction).
    The port builds the JAX defaults only: 32-wide latents, a 16x
    decimation; every `lstm_schedule` runs the wavefront kernels."""
    from .models import SeqVaeTeb
    from .models.vae_teb import LATENT_DIM, UPSAMPLE
    from .train.config import LSTM_SCHEDULES
    m = cfg.model
    latents = (m.latent_dim_source, m.latent_dim_target, m.latent_dim_z)
    if latents != (LATENT_DIM,) * 3 or m.decimation_factor != UPSAMPLE:
        raise ValueError(f"the port builds latent widths {LATENT_DIM} and "
                         f"decimation {UPSAMPLE}, got {latents} and "
                         f"{m.decimation_factor}")
    if m.lstm_schedule not in LSTM_SCHEDULES:
        raise ValueError(f"unknown lstm_schedule {m.lstm_schedule!r}")
    return SeqVaeTeb(input_channels=m.input_channels,
                     n_scattering=m.n_scattering, n_phase=m.n_phase,
                     seq_len=seq_len, dtype=cfg.trainer.model_dtype())


def _loaders(cfg, split: str, raw: bool = False):
    """The split's dataset, or None without paths. One path that is a
    directory loads as a PackedWindowStore (its raw_layout must match
    `raw`); anything else as a CombinedHDF5Dataset (raw: on-disk (C, S)
    layout, no host normalization)."""
    from .data import CombinedHDF5Dataset, PackedWindowStore
    ds_cfg = cfg.dataset
    paths = {"train": ds_cfg.train_paths,
             "val": ds_cfg.validation_paths}[split]
    if not paths:
        return None
    if len(paths) == 1 and os.path.isdir(paths[0]):
        store = PackedWindowStore(paths[0])
        packed_raw = bool(store.meta.get("raw_layout"))
        if packed_raw != raw:
            raise ValueError(
                f"packed store {paths[0]} was built with raw_layout="
                f"{packed_raw} but this run needs raw={raw} (device "
                "normalization expects a raw store; a normalized store must "
                "run without it)")
        return store
    return CombinedHDF5Dataset(
        paths, stats_path=ds_cfg.stat_path,
        normalize_fields=() if raw else ds_cfg.normalize_fields,
        trim_minutes=ds_cfg.trim_minutes, decimation=ds_cfg.decimation,
        cache_size=ds_cfg.cache_size, raw_layout=raw)


def run_training(cfg, device=None, resume: Union[bool, str] = False,
                 normalize_stats: Optional[Mapping] = None, log=None):
    """Train as `cli train` does; returns the Trainer.

    Builds the loaders (raw layout when `normalize_stats` is given: the
    trainer then normalizes on the device), the model from `cfg.model` at
    `cfg.trainer.precision` with seeded weights (`init_parameters`, seed
    `cfg.trainer.seed`), the trainer, the checkpointer (best
    `cfg.checkpoints.keep` plus the latest, in <run dir>/model_checkpoints)
    and the callbacks (history pickle, device-memory monitor). `resume`
    (True: this run's checkpoint directory; or a directory) restores the
    latest checkpoint and the history, and continues from the epoch after
    it. Then `Trainer.fit` over cfg.trainer.epochs.
    """
    from .init import init_parameters
    from .train import (Checkpointer, HistoryCallback, MemoryMonitorCallback,
                        Trainer)
    from .utils import get_logger
    log = log or get_logger()
    device = resolve_device(device)
    run_dir = cfg.run_dir()
    raw = normalize_stats is not None
    train_ds = _loaders(cfg, "train", raw=raw)
    val_ds = _loaders(cfg, "val", raw=raw)
    if train_ds is None:
        raise ValueError("no train_paths configured")
    sample = train_ds.read_batch(range(min(2, len(train_ds))))
    seq_len = sample["fhr_st"].shape[-1 if raw else 1]
    model = init_parameters(make_model(cfg, seq_len), seed=cfg.trainer.seed)
    trainer = Trainer(model, cfg.trainer, device,
                      normalize_stats=normalize_stats)
    bs = cfg.dataset.batch_size
    log.info("run dir: %s; device %s, batch %d, precision %s, moments %s, "
             "accumulate %d", run_dir, trainer.device, bs,
             cfg.trainer.precision, cfg.trainer.moment_dtype,
             cfg.trainer.accumulate_grad_batches)

    ckpt_dir = os.path.join(run_dir, "model_checkpoints")
    ckpt = Checkpointer(ckpt_dir, keep=cfg.checkpoints.keep)
    history_path = os.path.join(run_dir, "train_results", "history.pkl")
    start_epoch = 0
    if resume:
        resume_dir = resume if isinstance(resume, str) else ckpt_dir
        resume_ckpt = Checkpointer(resume_dir, keep=cfg.checkpoints.keep)
        latest = resume_ckpt.latest()
        if latest is None:
            log.warning("resume asked for but %s has no checkpoints; "
                        "starting fresh", resume_dir)
        else:
            trainer.load_state_dict(resume_ckpt.restore())
            start_epoch = int(latest["step"]) + 1
            log.info("resumed from %s (epoch %d, metric %s)",
                     latest["path"], latest["step"], latest["metric"])
            if os.path.exists(history_path):
                with open(history_path, "rb") as f:   # this run's own file
                    trainer.history = pickle.load(f)

    def train_batches(epoch):
        return train_ds.as_batches(bs, shuffle=True, seed=epoch)

    def val_batches(epoch):
        return val_ds.as_batches(cfg.dataset.eval_batch_size, shuffle=False,
                                 drop_last=False)

    callbacks = [HistoryCallback(history_path),
                 MemoryMonitorCallback(log_fn=log.warning)]
    trainer.fit(train_batches, val_batches if val_ds is not None else None,
                checkpointer=ckpt, log_fn=log.info, callbacks=callbacks,
                start_epoch=start_epoch)
    log.info("training complete: best checkpoint %s", ckpt.best())
    return trainer


def cmd_train(args) -> int:
    from .train import load_config
    from .utils import get_logger, setup_logging
    cfg = load_config(args.config, root=args.root)
    setup_logging(os.path.join(cfg.run_dir(), "train_results", "train.log"))
    log = get_logger()
    norm_stats = None
    if args.device_normalize:
        if not cfg.dataset.stat_path:
            log.error("--device-normalize needs dataset.stat_path")
            return 2
        from .data import load_stats
        norm_stats = load_stats(cfg.dataset.stat_path)
        if cfg.dataset.normalize_fields is not None:
            norm_stats = {k: v for k, v in norm_stats.items()
                          if k in cfg.dataset.normalize_fields}
    if not cfg.dataset.train_paths:
        log.error("no train_paths configured")
        return 2
    run_training(cfg, args.device, args.resume, norm_stats, log)
    return 0


def cmd_build_data(args) -> int:
    """Synthetic dataset through the frontend on `--device` (the card by
    default): the exact fp32 transform unless --reduced-frontend or
    --bf16-frontend; optionally its statistics file. Exits 1 when a
    record failed (--record-len mode reports it and goes on)."""
    from .data import (DatasetStatsCalculator, build_dataset,
                       build_dataset_from_records, synthetic_records)
    device = resolve_device(args.device)
    transform = None
    if args.bf16_frontend or args.reduced_frontend:
        import torch
        from .ops import PhaseScattering1D
        transform = PhaseScattering1D(
            J=args.J, Q=args.Q, T=args.T, shape=args.len_signal, max_order=1,
            correlation_dtype=torch.bfloat16 if args.bf16_frontend else None,
            reduced_rate=args.reduced_frontend, device=device)
    if args.record_len:
        # long-record ingest: block each record into overlapping windows
        res = build_dataset_from_records(
            args.out,
            synthetic_records(args.records, args.record_len, seed=args.seed),
            J=args.J, Q=args.Q, T=args.T, window=args.len_signal,
            overlap=args.overlap, transform=transform, device=device)
    else:
        res = build_dataset(args.out, n_records=args.records,
                            windows_per_record=args.windows,
                            len_signal=args.len_signal, seed=args.seed,
                            J=args.J, Q=args.Q, T=args.T,
                            transform=transform, device=device)
    print(f"built {args.out}: {res}")
    if args.stats_out:
        calc = DatasetStatsCalculator(trim_minutes=args.trim_minutes)
        stats = calc.calculate_stats([args.out])
        calc.save_stats(stats, args.stats_out)
        print(f"stats written to {args.stats_out}")
    return 0 if not res.get("errors") else 1


def cmd_stats(args) -> int:
    from .data import DatasetStatsCalculator
    calc = DatasetStatsCalculator(trim_minutes=args.trim_minutes)
    stats = calc.calculate_stats(args.data)
    calc.save_stats(stats, args.out)
    print(f"stats over {len(args.data)} file(s) written to {args.out}")
    return 0


def cmd_pack_data(args) -> int:
    """HDF5 dataset(s) -> a memory-mapped packed window store: trimmed,
    normalized (or, with --raw, raw (C, S) layout for --device-normalize
    training) fp32 bytes, read per epoch with no per-sample work."""
    from .data import CombinedHDF5Dataset, PackedWindowStore
    ds = CombinedHDF5Dataset(
        args.data, stats_path=args.stats,
        normalize_fields=() if args.raw else None,
        trim_minutes=args.trim_minutes, decimation=args.decimation,
        cache_size=0, raw_layout=args.raw)
    try:
        store = PackedWindowStore.build(ds, args.out,
                                        batch_size=args.batch_size)
    finally:
        ds.close()
    size = sum(os.path.getsize(os.path.join(args.out, f))
               for f in os.listdir(args.out))
    print(f"packed {len(store)} windows ({size / 1e6:.0f} MB, fields "
          f"{','.join(store.fields)}, raw_layout={args.raw}) -> {args.out}")
    return 0


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(prog="vae_teb_tpu_torch",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="command", required=True)
    pt = sub.add_parser("train", help="train the SeqVaeTeb model")
    pt.add_argument("--config", required=True)
    pt.add_argument("--root", default=None,
                    help="root for relative dataset paths")
    pt.add_argument("--resume", nargs="?", const=True, default=False,
                    metavar="CKPT_DIR",
                    help="resume from the latest checkpoint (optionally "
                         "from an explicit checkpoint directory)")
    pt.add_argument("--device-normalize", action="store_true",
                    dest="device_normalize",
                    help="feed raw-layout batches and normalize them on the "
                         "device inside the train step (needs "
                         "dataset.stat_path)")
    pt.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA card)")
    pt.set_defaults(fn=cmd_train)

    pb = sub.add_parser("build-data", help="build a synthetic dataset")
    pb.add_argument("--out", required=True)
    pb.add_argument("--records", type=int, default=16)
    pb.add_argument("--windows", type=int, default=4)
    pb.add_argument("--len-signal", type=int, default=5760)
    pb.add_argument("--record-len", type=int, default=0,
                    help="generate records of this length and window them "
                         "into --len-signal windows (0 = one window per "
                         "record, no blocking)")
    pb.add_argument("--overlap", type=float, default=0.5,
                    help="window overlap fraction for --record-len mode")
    pb.add_argument("--seed", type=int, default=0)
    pb.add_argument("--J", type=int, default=11)
    pb.add_argument("--Q", type=int, default=4)
    pb.add_argument("--T", type=int, default=16)
    pb.add_argument("--bf16-frontend", action="store_true",
                    help="bf16 correlation stage in the ETL frontend "
                         "(throughput mode; default = exact fp32)")
    pb.add_argument("--reduced-frontend", action="store_true",
                    help="reduced-rate pair pipeline in the ETL frontend "
                         "(throughput mode, oracle-bounded error)")
    pb.add_argument("--stats-out", default=None)
    pb.add_argument("--trim-minutes", type=float, default=2.0)
    pb.add_argument("--device", default=None,
                    help="torch device of the frontend (default: the CUDA "
                         "card)")
    pb.set_defaults(fn=cmd_build_data)

    ps = sub.add_parser("stats", help="compute normalization statistics")
    ps.add_argument("--data", nargs="+", required=True)
    ps.add_argument("--out", required=True)
    ps.add_argument("--trim-minutes", type=float, default=None)
    ps.set_defaults(fn=cmd_stats)

    pp = sub.add_parser("pack-data",
                        help="materialize HDF5 dataset(s) into a memory-"
                             "mapped training-ready packed window store")
    pp.add_argument("--data", nargs="+", required=True,
                    help="source HDF5 file(s)")
    pp.add_argument("--out", required=True, help="output directory")
    pp.add_argument("--stats", default=None,
                    help="normalization stats file (omit with --raw)")
    pp.add_argument("--trim-minutes", type=float, default=None)
    pp.add_argument("--decimation", type=int, default=16)
    pp.add_argument("--batch-size", type=int, default=64,
                    help="build streaming batch (bounds peak memory)")
    pp.add_argument("--raw", action="store_true",
                    help="pack raw (C, S) un-normalized bytes for "
                         "--device-normalize training")
    pp.set_defaults(fn=cmd_pack_data)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
