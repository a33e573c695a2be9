"""Where the time of a training step, and of a serving request, goes on
the card.

    python -m vae_teb_tpu_torch.profile_train [--precision fp32 bf16]

(one CUDA device). For each precision given (default fp32) it builds the
full-width SeqVaeTeb (seeded init) and a Trainer (fp32: the defaults;
bf16: the production policy, TrainerConfig(precision="bf16",
moment_dtype="bf16"); TF32 off), then at B = 32 and 128 on a fixed batch
of raw windows through the production frontend measures:

  step          host clock around train_step, synchronized (median of 5)
  frontend      CUDA events around the frontend (median of 5)
  forward       CUDA events around the train-mode forward and the loss
  wavefront fwd / bwd kernels, and the device's busy time per step: from a
                torch.profiler window of 3 steps (kernel time by name; busy
                time as the union of the kernels' time ranges)
  weight-grad GEMM  CUDA events around the (UH x K*B) @ (K*B x 4UH)
                product of WavefrontFunction's backward, at its shapes
  optimizer     CUDA events around ClippedAdamW.step()
  idle share    1 - device busy time per step / step time

and prints one JSON line per precision and batch size (also written to
chiprun_out/profile_train.json when that directory exists). Then, for a
serving request (`InferenceServer.infer`, eval mode) of the first
precision's model at B = 1, 8 and 32:

  request       host clock around infer, synchronized (median of 5)
  frontend      CUDA events around the frontend (median of 5)
  forward       CUDA events around the deterministic forward
  wavefront kernel and the device's busy time per request: from a
                torch.profiler window of 3 requests
  idle share    1 - device busy time per request / request time

one JSON line per batch size (chiprun_out/profile_serve.json).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

BATCHES = (32, 128)
SERVE_BATCHES = (1, 8, 32)
RUNS = 5
N = 5760


def cuda_ms(fn, runs: int = RUNS) -> float:
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernels(prof) -> list:
    """The device events of a profile that are kernels or copies: not
    host-side operators (whose device time repeats their kernels') and not
    annotations (record_function ranges mirrored on the device timeline)."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _busy_us(events) -> float:
    """Length of the union of the events' time ranges."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def _top(prof, n: int = 12, by_device: bool = False) -> list:
    """The n host operators with the most host time (by_device: the most
    device time of their own kernels): (name, calls, host ms, device ms,
    own device ms)."""
    rows = [(e.key, e.count, e.self_cpu_time_total / 1e3,
             getattr(e, "device_time_total", 0.0) / 1e3,
             getattr(e, "self_device_time_total", 0.0) / 1e3)
            for e in prof.key_averages()]
    return sorted(rows, key=lambda r: -r[4 if by_device else 2])[:n]


def _serve_rows(model, frontend_ops, device, smi) -> list:
    """The serving breakdown at each of SERVE_BATCHES."""
    from torch.profiler import ProfilerActivity, profile

    from . import InferenceServer
    server = InferenceServer(model, frontend_ops, device)
    gen = torch.Generator(device=device).manual_seed(7)
    rows = []
    for b in SERVE_BATCHES:
        x = torch.randn((2, b, N), generator=gen, device=device)
        for _ in range(2):
            server.infer(x[0], x[1])
        lat = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.infer(x[0], x[1])
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        request_ms = statistics.median(lat)
        coeffs = server.coefficients(x[0], x[1])
        frontend_ms = cuda_ms(lambda: server.coefficients(x[0], x[1]))
        forward_ms = cuda_ms(lambda: server.infer_coefficients(*coeffs))
        n_prof = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                server.infer(x[0], x[1])
            torch.cuda.synchronize()
        kernels = _kernels(prof)
        busy_ms = _busy_us(kernels) / 1e3 / n_prof
        row = {"batch": b, "request_ms": request_ms,
               "frontend_ms": frontend_ms, "forward_ms": forward_ms,
               "wavefront_fwd_kernel_ms": sum(
                   e.time_range.elapsed_us() for e in kernels
                   if "wavefront_fwd_kernel" in e.name) / 1e3 / n_prof,
               "device_busy_ms": busy_ms,
               "device_kernels_per_request": len(kernels) / n_prof,
               "idle_share": 1 - busy_ms / request_ms, "card": smi}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--precision", nargs="+", default=["fp32"],
                        choices=["fp32", "bf16"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device visible", file=sys.stderr)
        return 2
    from . import (PhaseScattering1D, SeqVaeTeb, Trainer, TrainerConfig,
                   WindowFrontend, init_parameters)

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    frontend = WindowFrontend(PhaseScattering1D(11, 4, 16, N, device=device))
    rows, serve_model = [], None
    for precision in args.precision:
        cfg = TrainerConfig(precision=precision, moment_dtype=precision)
        model = SeqVaeTeb(dtype=cfg.model_dtype())
        model.load_state_dict(init_parameters(SeqVaeTeb(), seed=2)
                              .state_dict())
        trainer = Trainer(model, cfg, device)
        rows += _train_rows(trainer, frontend, smi)
        if serve_model is None:
            serve_model = model
        del trainer
    serve_rows = _serve_rows(serve_model, frontend.frontend, device, smi)
    if os.path.isdir("chiprun_out"):
        for name, out in (("profile_train", rows), ("profile_serve",
                                                    serve_rows)):
            with open(os.path.join("chiprun_out", f"{name}.json"), "w") as f:
                json.dump(out, f, indent=1)
    return 0


def _train_rows(trainer, frontend, smi) -> list:
    """The training breakdown of `trainer` at each of BATCHES."""
    from torch.profiler import ProfilerActivity, profile

    from .models import compute_loss
    model, device = trainer.model, trainer.device
    gen = torch.Generator(device=device).manual_seed(6)
    rows = []
    for b in BATCHES:
        x = torch.randn((2, b, N), generator=gen, device=device)
        y_raw = torch.randn((b, model.decoder.raw_len), generator=gen,
                            device=device)
        coeffs = frontend(x[0], x[1])
        batch = dict(zip(("fhr_st", "fhr_ph", "fhr_up_ph"), coeffs), fhr=y_raw)
        torch.cuda.reset_peak_memory_stats(device)
        for _ in range(2):
            trainer.train_step(batch, 1e-5)
        steps = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(batch, 1e-5)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
        step_ms = statistics.median(steps)
        frontend_ms = cuda_ms(lambda: frontend(x[0], x[1]))

        def forward():
            out = model.train()(*coeffs, deterministic=False,
                                generator=trainer.generator)
            compute_loss(out, coeffs[0], coeffs[1], y_raw, beta=1e-5)
        forward_ms = cuda_ms(forward)

        K, G, UH = 303, 2048, 512
        h_prev = torch.randn((K * b, UH), device=device)
        dgates = torch.randn((K * b, G), device=device)
        gemm_ms = cuda_ms(lambda: h_prev.t() @ dgates)
        optimizer_ms = cuda_ms(trainer.optimizer.step)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.optimizer.step()
            torch.cuda.synchronize()
        optimizer_top = _top(prof)

        n_prof = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                trainer.train_step(batch, 1e-5)
            torch.cuda.synchronize()
        kernels = _kernels(prof)
        kernel_us = {key: sum(e.time_range.elapsed_us() for e in kernels
                              if f"wavefront_{key}_kernel" in e.name)
                     for key in ("fwd", "bwd")}
        busy_ms = _busy_us(kernels) / 1e3 / n_prof
        n_kernels = len(kernels)
        row = {"precision": trainer.config.precision,
               "moment_dtype": trainer.config.moment_dtype,
               "batch": b, "step_ms": step_ms, "frontend_ms": frontend_ms,
               "forward_ms": forward_ms,
               "wavefront_fwd_kernel_ms": kernel_us["fwd"] / 1e3 / n_prof,
               "wavefront_bwd_kernel_ms": kernel_us["bwd"] / 1e3 / n_prof,
               "weight_grad_gemm_ms": gemm_ms, "optimizer_ms": optimizer_ms,
               "device_busy_ms": busy_ms,
               "device_kernels_per_step": n_kernels / n_prof,
               "idle_share": 1 - busy_ms / step_ms,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(device),
               "optimizer_top_host_ops": optimizer_top,
               "step_top_host_ops": _top(prof),
               "step_top_device_ops": _top(prof, 16, by_device=True),
               "card": smi}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(main())
