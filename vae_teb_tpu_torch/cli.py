"""Command-line entry point of the port: train, test, export, build-data,
stats, pack-data.

    python -m vae_teb_tpu_torch.cli train --config configs/default.yaml \
        [--root DIR] [--resume [CKPT_DIR]] [--device-normalize] \
        [--plot-every 10] [--device cpu]
    torchrun --nproc_per_node=N -m vae_teb_tpu_torch.cli train \
        --config configs/default.yaml --multihost [--model-parallel M]
    python -m vae_teb_tpu_torch.cli test --config configs/default.yaml \
        [--checkpoint DIR] [--num-samples 50] [--with-scattering] \
        [--bf16-frontend] [--reduced-frontend] [--device cpu]
    python -m vae_teb_tpu_torch.cli export --config configs/default.yaml \
        --out model.pt2 [--checkpoint DIR] [--seq-len 300] [--static-batch B] \
        [--bundle-params] [--stream --chunk-len 1] [--platforms cuda|cpu] \
        [--device cpu]
    python -m vae_teb_tpu_torch.cli build-data --out data.h5 \
        [--records 16 --windows 8 --seed 0] [--stats-out stats.h5] [--device cpu]
    python -m vae_teb_tpu_torch.cli stats --data data.h5 --out stats.h5
    python -m vae_teb_tpu_torch.cli pack-data --data data.h5 --out DIR \
        [--stats stats.h5 | --raw]

Port of the `train`, `test`, `export`, `build-data`, `stats` and
`pack-data` subcommands of `vae_teb_tpu.cli`, with the same flags and
defaults. `train`, `test`, `export` and `build-data` run on the CUDA card
unless `--device` names another; `stats` and `pack-data` are host passes
over HDF5 files (h5py). `export` writes a `torch.export` program
(`serve.export_inference` / `export_source_stream`), traced on the device
it will run on: `--platforms` (cuda or cpu) names that device as
`--device` does, where the JAX package names the platforms it lowers for.

`cmd_train` reads the YAML config (and, with --device-normalize, the
statistics file) and calls `run_training`, which a program may call
directly with a `RunConfig` built in code: on a machine without PyYAML or
h5py, with train and validation paths that are packed window stores and
normalization statistics given as `FieldStats`. With --multihost each of
torchrun's ranks joins the process group (`parallel.init_distributed`:
NCCL on `cuda:LOCAL_RANK`, gloo with --device cpu) and trains its shard of
every global batch (the per-device batch times the world);
--model-parallel M lays the ranks out as (world / M) data x M model and
shards the wide decoder heads over each model group.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
from typing import Mapping, Optional, Union

import numpy as np

from .device import resolve_device


def make_model(cfg, seq_len: int):
    """The model family `cfg.model.family` names, SeqVaeTeb by default or
    SeqVaeTebForecast (the direct decoder, its 480-sample horizon and the
    config's `warmup_period`), at the config's precision, for sequences of
    `seq_len` steps (the port sizes SeqVaeTeb's decoder heads at
    construction). Every `lstm_schedule` runs the wavefront kernels."""
    from .models import SeqVaeTeb, SeqVaeTebForecast
    from .train.config import LSTM_SCHEDULES, MODEL_FAMILIES
    m = cfg.model
    if m.lstm_schedule not in LSTM_SCHEDULES:
        raise ValueError(f"unknown lstm_schedule {m.lstm_schedule!r}")
    if m.family not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {m.family!r}; one of "
                         f"{MODEL_FAMILIES}")
    kwargs = dict(input_channels=m.input_channels,
                  n_scattering=m.n_scattering, n_phase=m.n_phase,
                  seq_len=seq_len, dtype=cfg.trainer.model_dtype(),
                  latent_dim_source=m.latent_dim_source,
                  latent_dim_target=m.latent_dim_target,
                  latent_dim_z=m.latent_dim_z,
                  decimation_factor=m.decimation_factor)
    if m.family == "seqvae_teb_forecast":
        return SeqVaeTebForecast(warmup_period=m.warmup_period, **kwargs)
    return SeqVaeTeb(**kwargs)


def _loaders(cfg, split: str, raw: bool = False):
    """The split's dataset, or None without paths. One path that is a
    directory loads as a PackedWindowStore (its raw_layout must match
    `raw`); anything else as a CombinedHDF5Dataset (raw: on-disk (C, S)
    layout, no host normalization)."""
    from .data import CombinedHDF5Dataset, PackedWindowStore
    ds_cfg = cfg.dataset
    paths = {"train": ds_cfg.train_paths, "val": ds_cfg.validation_paths,
             "test": ds_cfg.test_paths}[split]
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
                 normalize_stats: Optional[Mapping] = None, log=None,
                 plot_every: int = 10, mesh=None):
    """Train as `cli train` does; returns the Trainer.

    Builds the loaders (raw layout when `normalize_stats` is given: the
    trainer then normalizes on the device), the model family
    `cfg.model.family` (`make_model`) at
    `cfg.trainer.precision` with seeded weights (`init_parameters`, seed
    `cfg.trainer.seed`), the trainer, the checkpointer (best
    `cfg.checkpoints.keep` plus the latest, in <run dir>/model_checkpoints)
    and the callbacks (history pickle, loss curves, device-memory monitor,
    and, for SeqVaeTeb, every `plot_every` epochs, 0 never,
    reconstructions of two validation windows; the plots need matplotlib
    and are logged and skipped without it). `resume`
    (True: this run's checkpoint directory; or a directory) restores the
    latest checkpoint and the history, and continues from the epoch after
    it. Then `Trainer.fit` over cfg.trainer.epochs.

    With a `mesh` (a rank of a torch.distributed run) the global batch is
    cfg.dataset.batch_size times the ranks; each rank reads its data
    shard's rows of it (shard_index / shard_count over the mesh's 'data'
    axis), validation is sharded with ragged tails dropped, rank 0 writes
    the checkpoints, the history and the figures (the reconstruction
    figures not at all under tensor parallelism, whose forward is a
    collective), and every rank watches its own device's memory.
    """
    from .init import init_parameters
    from .train import (Checkpointer, HistoryCallback, LossCurveCallback,
                        MemoryMonitorCallback, ReconstructionPlotCallback,
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
                      normalize_stats=normalize_stats, mesh=mesh)
    bs = cfg.dataset.batch_size
    rank = 0 if mesh is None else trainer.runner.rank
    n_data = 1 if mesh is None else mesh.axis_size("data")
    shard = 0 if mesh is None else mesh.coords["data"]
    global_bs = bs * (1 if mesh is None else mesh.size)
    local_bs = global_bs // n_data
    log.info("run dir: %s; device %s, mesh %s, per-device batch %d, global "
             "batch %d, precision %s, moments %s, accumulate %d", run_dir,
             trainer.device, mesh, bs, global_bs, cfg.trainer.precision,
             cfg.trainer.moment_dtype, cfg.trainer.accumulate_grad_batches)

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
        return train_ds.as_batches(local_bs, shuffle=True, seed=epoch,
                                   shard_index=shard, shard_count=n_data)

    def val_batches(epoch):
        return val_ds.as_batches(cfg.dataset.eval_batch_size, shuffle=False,
                                 drop_last=n_data > 1, shard_index=shard,
                                 shard_count=n_data)

    callbacks = [] if rank else [
        HistoryCallback(history_path),
        LossCurveCallback(os.path.join(run_dir, "train_results",
                                       "loss_curves.png"))]
    callbacks.append(MemoryMonitorCallback(log_fn=log.warning))
    tensor_parallel = mesh is not None and mesh.axis_size("model") > 1
    if tensor_parallel and plot_every > 0:
        log.info("no reconstruction figures under tensor parallelism: the "
                 "forward is a collective of the model group")
    if (not rank and not tensor_parallel and val_ds is not None
            and len(val_ds) and plot_every > 0 and model.raw_decoder):
        plot_batch = val_ds.read_batch(range(min(2, len(val_ds))))
        if raw:
            # the plot callback feeds the model directly: normalize and
            # transpose to the model's layout on the host once
            from .data.normalize import normalize_field_inplace
            for k in ("fhr_st", "fhr_ph", "fhr_up_ph"):
                v = plot_batch[k].copy()
                if k in normalize_stats:
                    v = normalize_field_inplace(v, k, normalize_stats[k],
                                                channel_axis=-2)
                plot_batch[k] = np.ascontiguousarray(np.swapaxes(v, 1, 2))
            if "fhr" in normalize_stats:
                plot_batch["fhr"] = normalize_field_inplace(
                    plot_batch["fhr"].copy(), "fhr", normalize_stats["fhr"])
        callbacks.append(ReconstructionPlotCallback(
            os.path.join(run_dir, "train_results", "reconstructions"),
            plot_batch, every=plot_every))
    trainer.fit(train_batches, val_batches if val_ds is not None else None,
                checkpointer=ckpt, log_fn=log.info, callbacks=callbacks,
                start_epoch=start_epoch)
    log.info("training complete: best checkpoint %s", ckpt.best())
    return trainer


def cmd_train(args) -> int:
    """Train from the YAML config; with --multihost as one of torchrun's
    ranks, leaving the process group when done."""
    device, rank, world = args.device, 0, 1
    if args.multihost:
        from .parallel import init_distributed
        info = init_distributed(device=args.device)
        device, rank, world = info.device, info.rank, info.world_size
    try:
        return _train(args, device, rank, world)
    finally:
        if args.multihost:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, device, rank: int, world: int) -> int:
    from .train import load_config
    from .utils import get_logger, setup_logging
    cfg = load_config(args.config, root=args.root)
    setup_logging(os.path.join(cfg.run_dir(), "train_results",
                               "train.log" if world == 1
                               else f"train_rank{rank}.log"))
    log = get_logger()
    log.info("process %d/%d", rank, world)
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
    mesh, tp = None, args.model_parallel
    if world % tp:
        log.error("--model-parallel %d does not divide %d devices", tp, world)
        return 2
    if args.multihost:
        from .parallel import data_parallel_mesh, hybrid_mesh
        mesh = hybrid_mesh(world // tp, tp) if tp > 1 else data_parallel_mesh()
    run_training(cfg, device, args.resume, norm_stats, log,
                 plot_every=args.plot_every, mesh=mesh)
    return 0


def cmd_test(args) -> int:
    """The evaluation suite on the best checkpoint (a fresh seeded model
    without one) over the test split, else the validation split, into
    <run dir>/test_results. With --with-scattering the shift and gain
    analyses recompute the cross-phase coefficients through the production
    geometry (J=11, Q=4, T=16, 5760 samples) on the device: exact fp32 by
    default, reduced rate or bf16 products on request."""
    from .data import CombinedHDF5Dataset, load_stats
    from .eval import ModelEvaluator, run_evaluation_suite
    from .init import init_parameters
    from .ops import PhaseScattering1D
    from .train import Checkpointer, load_config
    from .utils import get_logger, setup_logging

    cfg = load_config(args.config, root=args.root)
    run_dir = cfg.run_dir()
    out_dir = os.path.join(run_dir, "test_results")
    setup_logging(os.path.join(out_dir, "test.log"))
    log = get_logger()

    test_ds = _loaders(cfg, "test") or _loaders(cfg, "val")
    if test_ds is None:
        log.error("no test/validation paths configured")
        return 2
    device = resolve_device(args.device)
    seq_len = test_ds.read_batch(range(min(2, len(test_ds))))[
        "fhr_st"].shape[1]
    model = init_parameters(make_model(cfg, seq_len), seed=cfg.trainer.seed)
    ckpt_dir = args.checkpoint or cfg.checkpoints.test_checkpoint_path
    if ckpt_dir:
        ckpt = Checkpointer(ckpt_dir, keep=cfg.checkpoints.keep)
        model.load_state_dict(ckpt.restore(best=True)["model"])
        log.info("restored best checkpoint from %s", ckpt_dir)
    else:
        log.warning("no checkpoint given: evaluating a fresh model")

    scattering = stats = raw_ds = sel_subset = None
    if args.with_scattering:
        import torch
        scattering = PhaseScattering1D(
            J=11, Q=4, T=16, shape=5760, max_order=1,
            correlation_dtype=torch.bfloat16 if args.bf16_frontend else None,
            reduced_rate=args.reduced_frontend, device=device)
        if cfg.dataset.stat_path:
            stats = load_stats(cfg.dataset.stat_path)
        raw_paths = cfg.dataset.test_paths or cfg.dataset.validation_paths
        raw_ds = CombinedHDF5Dataset(
            raw_paths, stats_path=cfg.dataset.stat_path,
            normalize_fields=("fhr_st", "fhr_ph", "fhr_up_ph"),
            cache_size=0, allow_stats_trim_mismatch=True)
        sel = scattering.optimal_fhr_selection()
        sel_subset = sel["cross_selection"]["selected_indices"]

    evaluator = ModelEvaluator(model, scattering=scattering, stats=stats,
                               cross_subset=sel_subset, device=device)
    results = run_evaluation_suite(
        evaluator, test_ds, out_dir, raw_dataset=raw_ds,
        num_samples=args.num_samples,
        run_shift_analysis=args.with_scattering,
        run_gain_sweep=args.with_scattering)
    log.info("evaluation artifacts in %s", out_dir)
    m = results["metrics"]
    log.info("VAF %.4f+-%.4f  MSE %.5f  SNR %.2f dB  TE %.5f",
             m["vaf"].mean(), m["vaf"].std(), m["mse"].mean(),
             m["snr_db"].mean(), m["kld"].mean())
    return 0


def cmd_export(args) -> int:
    """Trace the best checkpoint (fresh seeded weights without one, with a
    warning) into a serving artifact: the deterministic forward from
    coefficients (a symbolic batch unless --static-batch), or with
    --stream one source-encode step of --chunk-len steps at a static batch
    (--static-batch, default 1); weights as argument unless
    --bundle-params."""
    from . import serve
    from .init import init_parameters
    from .train import Checkpointer, load_config

    device = resolve_device(args.device)
    cfg = load_config(args.config, root=args.root)
    model = init_parameters(make_model(cfg, args.seq_len),
                            seed=cfg.trainer.seed)
    ckpt_dir = args.checkpoint or cfg.checkpoints.test_checkpoint_path
    if ckpt_dir:
        ckpt = Checkpointer(ckpt_dir, keep=cfg.checkpoints.keep)
        model.load_state_dict(ckpt.restore(best=True)["model"])
    else:
        print("warning: no checkpoint given, exporting fresh weights")
    b = args.static_batch or 1
    if args.stream:
        program = serve.export_source_stream(
            model, batch_size=b, chunk_len=args.chunk_len,
            n_channels=cfg.model.input_channels,
            bundle_params=args.bundle_params, device=device)
    else:
        m = cfg.model
        batch = {k: np.zeros((b, args.seq_len, c), np.float32)
                 for k, c in zip(serve.COEFF_KEYS, (m.n_scattering, m.n_phase,
                                                    m.input_channels))}
        program = serve.export_inference(
            model, batch, batch_polymorphic=args.static_batch is None,
            bundle_params=args.bundle_params, device=device)
    n = serve.save_artifact(program, args.out)
    kind = "stream step" if args.stream else "inference"
    print(f"exported {kind} ({n / 1e6:.1f} MB, device={device}, "
          f"{'bundled weights' if args.bundle_params else 'weights as argument'}"
          f") -> {args.out}")
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
    pt = sub.add_parser("train", help="train the model family the config's "
                        "model.family names (SeqVaeTeb by default)")
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
    pt.add_argument("--model-parallel", type=int, default=1,
                    dest="model_parallel", metavar="N",
                    help="shard the wide decoder heads over N ranks (hybrid "
                         "data x model mesh); default pure data parallelism")
    pt.add_argument("--multihost", action="store_true",
                    help="join torchrun's process group first: one rank per "
                         "device (cuda:LOCAL_RANK over NCCL, or the CPU over "
                         "gloo with --device cpu); each rank trains its "
                         "shard of every global batch")
    pt.add_argument("--plot-every", type=int, default=10,
                    help="epochs between val-reconstruction plots "
                         "(0 disables)")
    pt.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA "
                         "card; with --multihost, cuda:LOCAL_RANK)")
    pt.set_defaults(fn=cmd_train)

    pe = sub.add_parser("test", help="run the evaluation suite")
    pe.add_argument("--config", required=True)
    pe.add_argument("--root", default=None)
    pe.add_argument("--checkpoint", default=None)
    pe.add_argument("--num-samples", type=int, default=50)
    pe.add_argument("--bf16-frontend", action="store_true",
                    help="bf16 correlation stage in the recompute frontend")
    pe.add_argument("--reduced-frontend", action="store_true",
                    help="reduced-rate pair pipeline in the recompute "
                         "frontend")
    pe.add_argument("--with-scattering", action="store_true",
                    help="enable shift/gain analyses (on-device scattering)")
    pe.add_argument("--device", default=None,
                    help="torch device to evaluate on (default: the CUDA "
                         "card)")
    pe.set_defaults(fn=cmd_test)

    px = sub.add_parser("export",
                        help="trace a checkpoint into a torch.export serving "
                             "artifact")
    px.add_argument("--config", required=True)
    px.add_argument("--root", default=None)
    px.add_argument("--checkpoint", default=None)
    px.add_argument("--out", required=True, help="artifact file path")
    px.add_argument("--seq-len", type=int, default=300,
                    help="decimated sequence length (default: production "
                         "300)")
    px.add_argument("--static-batch", type=int, default=None, metavar="B",
                    help="export at a fixed batch size (default: symbolic "
                         "batch - one artifact serves every size)")
    px.add_argument("--platforms", dest="device", choices=("cuda", "cpu"),
                    help="JAX's flag, here the one device the program is "
                         "traced for and runs on: the same as --device")
    px.add_argument("--bundle-params", action="store_true",
                    help="keep the weights in the artifact (self-contained "
                         "file) instead of taking them as an argument")
    px.add_argument("--stream", action="store_true",
                    help="export the incremental source-encode step "
                         "instead of the full forward")
    px.add_argument("--chunk-len", type=int, default=1,
                    help="chunk length for --stream (default 1: per-"
                         "timestep serving)")
    px.add_argument("--device", default=None,
                    help="torch device to trace on (default: the CUDA card)")
    px.set_defaults(fn=cmd_export)

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
