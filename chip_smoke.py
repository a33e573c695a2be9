#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on an NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases, each of which raises on failure (exit code 1):
  1. device: CUDA must be present (exit 2 otherwise, before any result);
  2. build the wavefront kernel (vae_teb_tpu_torch/kernels/wavefront_fwd.cu)
     with nvcc for sm_90a;
  3. kernel against its plain PyTorch version on the card, at the serving
     shape (B=32, two 4-layer H=64 streams, S=300, K=303) and a 4+2-layer
     shape, in fp32 (max-abs <= 1e-5) and bf16 storage (<= 1.6e-2), with
     CUDA-event times (median of 15 runs);
  4. serve raw (B, 5760) FHR/UP windows at B = 1, 8 and 32 through the
     full-width fp32 model (seeded init) and the production reduced-rate
     frontend; check shapes, finiteness, that every forward launched the
     kernel, agreement with the plain recurrence on the card, and
     agreement with a CPU run on a B=1 window;
  5. print the card's nvidia-smi name and power limit, one JSON line for
     the kernels, and last {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N = 5760
BATCHES = (1, 8, 32)
REQUESTS = 5          # timed requests per batch size (after one warm-up)
TIMED_RUNS = 15       # kernel / plain timing repeats
FP32_TOL, BF16_TOL = 1e-5, 1.6e-2
SERVE_REL_TOL = 1e-4  # kernel vs plain recurrence in the full model
# Seed 0's final single-channel ReLU conv is dead on these inputs (the
# decoder heads would see zeros and their check would be vacuous); seed 2's
# is active.
INIT_SEED = 2
OUT_KEYS = ("z", "linear_output", "mu_pr", "logvar_pr", "mu_x", "mu_prior",
            "logvar_prior", "mu_post", "logvar_post")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median device time of fn() over `runs` calls, after one warm-up."""
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


def recurrence_inputs(gen, b, s, h, depths, dtype, device):
    """Random wavefront operands (W_eff, b, xs_wave, h0, c0, lvec) from a
    seeded CPU generator."""
    U = sum(depths)
    UH, K = U * h, s + max(depths) - 1
    rnd = lambda *shape: torch.randn(shape, generator=gen)
    lvec = torch.as_tensor(np.concatenate([np.arange(d) for d in depths]),
                           dtype=torch.int32)
    args = (rnd(UH, 4 * UH) / np.sqrt(UH), rnd(4 * UH) * 0.1,
            rnd(K, b, 4 * UH), rnd(b, UH) * 0.2, rnd(b, UH) * 0.2)
    return tuple(a.to(device=device, dtype=dtype) for a in args) + (
        lvec.to(device),)


def check_kernel(device):
    from vae_teb_tpu_torch.kernels import wavefront_fwd, wavefront_fwd_plain
    gen = torch.Generator().manual_seed(0)
    results = {}
    for label, depths in (("2x4 layers", (4, 4)), ("4+2 layers", (4, 2))):
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            args = recurrence_inputs(gen, 32, 300, 64, depths, dtype, device)
            got = wavefront_fwd(*args, 300)
            want = wavefront_fwd_plain(*args, 300)
            torch.cuda.synchronize()
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
            ms = cuda_time_ms(lambda: wavefront_fwd(*args, 300))
            plain_ms = cuda_time_ms(lambda: wavefront_fwd_plain(*args, 300))
            log(f"kernel {label} B=32 S=300 {str(dtype)[6:]}: "
                f"max_abs_err={err!r} (tol {tol}) kernel {ms!r} ms, "
                f"plain {plain_ms!r} ms")
            if not err <= tol:
                raise AssertionError(f"wavefront kernel disagrees with its "
                                     f"plain version: {err} > {tol}")
            results[(label, dtype)] = (err, ms, plain_ms)
    return results


def serve(device):
    from vae_teb_tpu_torch import (InferenceServer, PhaseScattering1D,
                                   SeqVaeTeb, init_parameters)
    from vae_teb_tpu_torch.kernels import wavefront_fwd, wavefront_fwd_plain

    t0 = time.perf_counter()
    model = init_parameters(SeqVaeTeb(), seed=INIT_SEED)
    server = InferenceServer(model, PhaseScattering1D(11, 4, 16, N,
                                                      device=device), device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serving set-up (init {n_params} params, frontend plan): "
        f"{time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device=device).manual_seed(1)
    windows = {b: [torch.randn((2, b, N), generator=gen, device=device)
                   for _ in range(REQUESTS + 1)] for b in BATCHES}
    S = 300
    shapes = {"z": (S, 32), "linear_output": (S, 87), "mu_pr": (16 * S,),
              "logvar_pr": (16 * S,), "mu_x": (S, 32), "mu_prior": (S, 32),
              "logvar_prior": (S, 32), "mu_post": (S, 32),
              "logvar_post": (S, 32)}

    torch.cuda.reset_peak_memory_stats(device)
    wavefront_fwd.launches = 0
    calls, stats, kept = 0, {}, {}
    for b in BATCHES:
        lat = []
        for r, x in enumerate(windows[b]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = server.infer(x[0], x[1])
            torch.cuda.synchronize()
            if r:                                  # request 0 warms up
                lat.append(time.perf_counter() - t)
            calls += 1
            for k in OUT_KEYS:
                want = (b,) + shapes[k]
                if tuple(out[k].shape) != want:
                    raise AssertionError(f"{k}: shape {tuple(out[k].shape)}, "
                                         f"expected {want}")
                if not torch.isfinite(out[k]).all():
                    raise AssertionError(f"{k}: non-finite values at B={b}")
        if not out["mu_pr"].abs().max() > 0:
            raise AssertionError("decoder heads produced only zeros")
        kept[b] = out
        med = statistics.median(lat)
        stats[b] = (med * 1e3, b / med)
    launches = wavefront_fwd.launches
    peak = torch.cuda.max_memory_allocated(device)
    if launches != calls:
        raise AssertionError(f"wavefront kernel launched {launches} times "
                             f"in {calls} forwards")
    for b in BATCHES:
        log(f"serve B={b}: median latency {stats[b][0]!r} ms over "
            f"{REQUESTS} requests, {stats[b][1]!r} windows/s")
    log(f"serve peak device memory {peak} bytes; wavefront launches "
        f"{launches} in {calls} forwards")

    # the same last B=8 request through the plain recurrence on the card
    x = windows[8][-1]
    model.recurrence = wavefront_fwd_plain
    try:
        plain = server.infer(x[0], x[1])
    finally:
        model.recurrence = wavefront_fwd
    worst = 0.0
    for k in OUT_KEYS:
        ref = plain[k]
        err = (kept[8][k] - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        worst = max(worst, rel)
        if not rel <= SERVE_REL_TOL:
            raise AssertionError(f"{k}: kernel vs plain recurrence "
                                 f"{rel} > {SERVE_REL_TOL} of max")
    log(f"serve kernel vs plain recurrence (B=8): worst max-abs/max "
        f"{worst!r} (tol {SERVE_REL_TOL})")

    check_against_cpu(server, windows[1][-1])
    return launches


def check_against_cpu(server, x):
    """One B=1 window through the whole path on the CPU (plain PyTorch):
    coefficients at the frontend's own bars, then the model on identical
    coefficients to 1e-4 of max."""
    import copy
    from vae_teb_tpu_torch import InferenceServer, PhaseScattering1D
    cpu = InferenceServer(copy.deepcopy(server.model).cpu(),
                          PhaseScattering1D(11, 4, 16, N), "cpu")
    coeff_gpu = [c.cpu() for c in server.coefficients(x[0], x[1])]
    coeff_cpu = cpu.coefficients(x[0].cpu(), x[1].cpu())
    st_g, ph_g, cr_g = coeff_gpu
    st_c, ph_c, cr_c = coeff_cpu
    rel_l2 = lambda a, b: ((a - b).norm() / b.norm()).item()
    st_err = ((st_g - st_c).abs().max() / st_c.abs().max()).item()
    ph_err, cr_err = rel_l2(ph_g, ph_c), rel_l2(cr_g, cr_c)
    log(f"frontend GPU vs CPU (B=1): scattering max-abs/max {st_err!r}, "
        f"phase rel-L2 {ph_err!r}, cross rel-L2 {cr_err!r}")
    if not (st_err < 2e-5 and ph_err <= 1e-4 and cr_err <= 5e-2):
        raise AssertionError("frontend on the card disagrees with the CPU")
    gpu_out = server.infer_coefficients(*coeff_cpu)
    cpu_out = cpu.infer_coefficients(*coeff_cpu)
    worst = 0.0
    for k in OUT_KEYS:
        ref = cpu_out[k]
        rel = ((gpu_out[k].cpu() - ref).abs().max()
               / max(ref.abs().max().item(), 1e-30)).item()
        worst = max(worst, rel)
        if not rel <= SERVE_REL_TOL:
            raise AssertionError(f"{k}: card vs CPU {rel} > {SERVE_REL_TOL}")
    log(f"model GPU vs CPU on identical coefficients (B=1): worst "
        f"max-abs/max {worst!r} (tol {SERVE_REL_TOL})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    # full fp32 everywhere: the JAX reference runs HIGHEST-precision fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    from vae_teb_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.load("wavefront_fwd.cu")
    log(f"built wavefront_fwd.cu in {time.perf_counter() - t0:.2f} s")
    for line in build.build_logs.get("wavefront_fwd.cu", "").splitlines():
        if "ptxas info" in line:
            log(line.strip())

    kernel_results = check_kernel(device)
    launches = serve(device)

    err, ms, plain_ms = kernel_results[("2x4 layers", torch.float32)]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "wavefront_fwd", "route": "cuda",
        "source": "vae_teb_tpu_torch/kernels/wavefront_fwd.cu",
        "replaces": "vae_teb_tpu/models/wavefront_pallas.py:80",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
