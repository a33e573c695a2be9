"""Closed-loop training of the direct-window forecaster
(`SeqVaeTebForecast(decoder_type="direct")`): the port's
`Trainer.train_multi_step`, fed as `fit` feeds it, under the protocol of
`drivers/train.py`.

Set-up builds one trainer (the forecaster made on the device from the
seed, normalization statistics, the configuration's trainer values and
precision) and one feed: a pool of training windows made from the seed
(`data.coefficient_pool`: raw windows through the reference frontend),
drawn in seeded order, staged by `prefetch_to_device` and stacked K to a
group on the device. The sampling noise of each step is drawn from the
seed on the device and handed to the step, so that the reference can
draw it again.

The first step of a shape runs eagerly and the step's CUDA graph is
captured after it, so that step only warms up: afterwards the
parameters, the BatchNorm statistics, the Adam moments and the update
count are written back in place to what the seed made and the noise
generator is seeded again. Then the trainer takes three replayed steps
from the seed: one (Adam's first moments after it are read) and two (the
parameters' change over the three is read), then a warm group of K.
Then the window: groups of K replays, back to back, with at most two
groups in flight, for `seconds` of the host clock; every group enqueued
is waited for and counted, and a step whose loss is not finite counts
as failed. A traced run waits for the groups in flight, then profiles
`trace_groups` groups.

After the window (and the program's state freed) the plain reference
(`reference/forecast.py`) takes the same three steps from the same
weights, rows and noise in float64.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import data, weights
from ..checks import check_against, train_numbers, train_readings_of
from ..counts_forecast import PEAK_FLOPS, grid_least_s, step_flops
from ..reference.forecast import param_shapes, reference_steps
from .train import _stats


def _model(cfg, device):
    from vae_teb_tpu_torch.models import SeqVaeTebForecast
    m = cfg["model"]
    dtype = torch.bfloat16 if cfg["precision"] == "bf16" else None
    with torch.device(device):
        model = SeqVaeTebForecast(
            decoder_type=m["decoder_type"],
            prediction_horizon=m["prediction_horizon"],
            warmup_period=m["warmup_period"],
            input_channels=m["input_channels"], n_scattering=m["n_scattering"],
            n_phase=m["n_phase"], lstm_hidden_dim=m["lstm_hidden_dim"],
            lstm_num_layers=m["lstm_num_layers"], seq_len=m["seq_len"],
            dtype=dtype, latent_dim_source=m["latent_dim"],
            latent_dim_target=m["latent_dim"], latent_dim_z=m["latent_dim"],
            decimation_factor=m["decimation_factor"])
    shapes = param_shapes(m)
    state = model.state_dict()
    got = {k: tuple(v.shape) for k, v in state.items()}
    if got != dict(shapes):
        missing = sorted(set(shapes) ^ set(got))[:5]
        raise RuntimeError(f"the program's parameters differ from the "
                           f"configuration's: {missing}")
    weights.fill(state, shapes, cfg["seed"])
    return model, shapes


def run(ctx) -> Dict:
    from vae_teb_tpu_torch import Trainer, TrainerConfig
    from vae_teb_tpu_torch.data.dataset import prefetch_to_device

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    m, tc = cfg["model"], cfg["trainer"]
    B, K = tr["batch"], tr["steps_per_execution"]
    model, shapes = _model(cfg, dev)
    ctx.mark("model")
    pool, raw_stats = data.coefficient_pool(cfg, tr["pool_windows"], ctx.seed,
                                            dev)
    trainer = Trainer(model, TrainerConfig(
        lr=tc["lr"], grad_clip_norm=tc["grad_clip_norm"],
        weight_decay=tc["weight_decay"], kld_beta=tc["kld_beta"],
        precision=cfg["precision"], moment_dtype=cfg["moment_dtype"],
        steps_per_execution=K, prefetch=tr["prefetch"], seed=ctx.seed),
        device=dev, normalize_stats=_stats(raw_stats))
    ctx.mark("pool")
    rows: List[np.ndarray] = []

    def batches():
        for idx in data.batch_order(tr["pool_windows"], B, ctx.seed):
            if len(rows) < 4:
                rows.append(idx)
            yield {f: pool[f][idx] for f in data.FIELDS}

    feed = prefetch_to_device(batches(), size=tr["prefetch"], device=dev,
                              array_fields=data.FIELDS)
    noise = torch.Generator(device=dev)
    noise.manual_seed(ctx.seed)
    tracer, timer = ctx.tracer, ctx.timer
    eps_shape = (B, m["seq_len"], m["latent_dim"])

    def group(k: int):
        with tracer.span("stage_wait"):
            items = [next(feed) for _ in range(k)]
        with tracer.span("train_multi_step"):
            stacked = {f: torch.stack([b[f] for b in items])
                       for f in data.FIELDS}
            eps = torch.randn((k,) + eps_shape, generator=noise, device=dev)
            return trainer.train_multi_step(stacked, tc["kld_beta"], eps)

    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    seeded = {k: v.detach().clone() for k, v in model.state_dict().items()}
    group(1)                                   # eager, then captured
    ctx.sync()
    ctx.mark("eager step and capture")
    opt = trainer.optimizer
    with torch.no_grad():                      # back to the seed, in place
        for k, v in model.state_dict().items():
            v.copy_(seeded[k])
        for state in opt.state.values():
            for v in state.values():
                v.zero_()
        opt.count.zero_()
    del seeded
    noise.manual_seed(ctx.seed)
    p0 = [p.detach().clone() for p in params]
    first = group(1)                           # replays from here on
    # a parameter the loss does not reach has no moments: its gradient is 0
    mu = [opt.state[p]["mu"].float() if "mu" in opt.state.get(p, {}) else
          torch.zeros_like(p) for p in params]
    grad1 = (torch.stack(torch._foreach_norm(mu)) / 0.1).cpu().numpy()
    second = group(2)
    change = torch.stack(torch._foreach_norm(torch._foreach_sub(
        [p.detach() for p in params], p0))).cpu().numpy()
    losses = torch.cat([first["total_loss"], second["total_loss"]]).cpu()
    del p0, mu
    group(K)                                   # warm: K replays
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0
    tracer.host.clear()
    tracer.calls.clear()

    done, pending, losses_w = 0, None, []
    t_start = time.perf_counter()
    while True:
        if ctx.trace and done == tr["trace_after_groups"]:
            tracer.start()
        timer.begin("group")
        out = group(K)
        timer.end("group")
        losses_w.append(out["total_loss"])
        if tracer.prof is not None and tracer.units == 0 and \
                done + 1 == tr["trace_after_groups"] + tr["trace_groups"]:
            tracer.stop()
            tracer.units = K * tr["trace_groups"]
        ev = ctx.event()
        if pending is not None:
            pending.synchronize()
        pending = ev
        done += 1
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t_start
    steps = done * K
    if tracer.prof is not None and tracer.units == 0:   # the window closed first
        tracer.stop()
        tracer.units = (done - tr["trace_after_groups"]) * K
    failed = int((~torch.isfinite(torch.cat(losses_w))).sum())
    memory_peak = ctx.memory_peak()
    group_ms = timer.ms("group")
    trace = tracer.summary(start_after="train_multi_step")
    feed.close()
    del trainer, model, params, out, losses_w, feed, opt
    ctx.free()

    prog = train_readings_of(losses.numpy(), grad1, change, names)
    ref = reference_steps(cfg, shapes, pool, raw_stats, rows[1:], ctx.seed,
                          B, dev)
    numbers = train_numbers(prog, ref)
    ctx.note(f"worst leaves: gradient {numbers.pop('grad_leaf')}, "
             f"change {numbers.pop('change_leaf')}")
    model_cfg = {**m, "precision": cfg["precision"]}
    return {
        "attempted": steps, "failed": failed, "memory_peak": memory_peak,
        "end_to_end": {"train_windows_per_s": steps * B / window_s,
                       "setup_s": setup_s},
        "checks": check_against(numbers, ctx.limits),
        "numbers": numbers,
        "readings": {
            "kind": "train", "steps": steps, "window_s": window_s,
            "host": dict(tracer.host), "calls": dict(tracer.calls),
            "group_ms": group_ms, "K": K,
            "flops_per_step": step_flops(model_cfg, B),
            "peak_flops": PEAK_FLOPS[cfg["precision"]],
            "grid_least_s": grid_least_s(model_cfg, B),
            "trace": trace},
    }
