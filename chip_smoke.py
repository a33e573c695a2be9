#!/usr/bin/env python3
"""Drive the PyTorch port's serving path, training step, training entry
point, exact frontend and dataset ETL on an NVIDIA GPU.

    python3 chip_smoke.py             # from the repository root, one CUDA device
    python3 chip_smoke.py --kernels   # phases 1-3 only, printing no result

Run with --kernels from a copy placed at the root of another checkout, it
times that checkout's kernels (the wrappers' signatures are unchanged since
the first kernels), so two versions compare on one card.

Phases, each of which raises on failure (exit code 1):
  1. device: CUDA must be present (exit 2 otherwise, before any result);
  2. build the wavefront kernels (vae_teb_tpu_torch/kernels/wavefront_fwd.cu
     and wavefront_bwd.cu, one nvcc each, in parallel) for sm_90a; print
     each instantiation's ptxas registers and spills, and the launch plan
     of each main-path batch (rows per cluster, clusters of 8 CTAs, shared
     memory) with the clusters the card holds at once;
  3. kernels against their plain PyTorch versions on the card, at the
     serving/training shape (two 4-layer H=64 streams, S=300, K=303) at
     B = 32 (fp32 and bf16 storage), 128 and 1, and a 4+2-layer shape:
     the serving forward and the residual forward (max-abs <= 1e-5 fp32,
     1.6e-2 bf16; the stored gates per element to that times max(1,
     |gate|)), the reverse wavefront (max-abs <= 1e-5 fp32, 3e-2 bf16, of
     max|plain| on each output). At 2x4 layers, B = 32 and 128 fp32 and
     B = 32 bf16, also CUDA-event times (median of 15 runs; plain 5), the
     bound (fp32 operations on the non-zero weight blocks over 67 TFLOP/s,
     or bytes over 3.35 TB/s) and the yardstick: cuDNN's LSTM
     (`torch.nn.LSTM`, one per stream) computing the same function, held
     to the kernel's outputs at 1e-4 of max (bf16 storage: 1.6e-2) and
     timed forward and backward-data;
  4. serve raw (B, 5760) FHR/UP windows at B = 1, 8 and 32 through the
     full-width fp32 model (seeded init) and the production reduced-rate
     frontend; check shapes, finiteness, that every forward launched the
     serving kernel, agreement with the plain recurrence on the card, and
     agreement with a CPU run on a B=1 window;
  5. train the full-width model (Trainer defaults: fp32, beta 1e-5, clip
     0.5, AdamW lr 1e-4): 10 steps at B=32 and 5 at B=128 on fixed batches
     of raw windows through the frontend on the card; check finite losses,
     a falling B=32 loss, one residual-forward and one backward launch per
     step; then one B=8 step against the plain recurrence on the card and
     one B=2 step against the CPU on identical coefficients and noise;
  6. the bf16 compute policy's forward: full-width SeqVaeTeb(dtype=bf16)
     on the same seeded weights against the fp32 model on the card (B=32,
     eval mode, every output within 0.1 of its max) and against the CPU's
     plain path at B=1; the bf16 forward launched wavefront_fwd_bf16 once;
  7. bf16 training (TrainerConfig(precision="bf16", moment_dtype="bf16")):
     phase 5's steps, each launching wavefront_fwd_res_bf16 and
     wavefront_bwd_bf16 once, median step times beside phase 5's; then one
     B=8 step: float32 gradients, held leaf by leaf against the plain
     reverse wavefront on a shared forward; losses against the CPU, and
     the gradients' distance from the CPU's against the CPU's own move
     when the coefficients move by half a bf16 ulp;
  8. fit through the training entry point (`cli.run_training`): seeded
     windows through the frontend into two packed window stores (raw
     layout), a RunConfig built in code (bf16, batch 32, accumulation 2,
     prefetch 2, keep 2, device normalization), 3 epochs, then a resume
     for a 4th; checks the history, the checkpoints kept, the restored
     state bit for bit, the optimizer's count, and that prefetch handed
     the steps tensors on the card;
  9. the exact frontend and the ETL (no kernel of its own): order-2
     scattering against the torch reference's golden (small_o2_*, 2e-5 of
     max) and at J=11, Q=4, T=16, B=8 against the CPU; the exact
     PhaseScattering1D on the production fixtures, all 903 pairs against
     the golden (3e-2 / 8e-2 of max), the 44 / 130 selections against a
     float64 oracle (rel-L2 5e-4 / 3.3e-2), analyze at B=8 against the
     CPU; the decimation GEMM against float64 with TF32 off (and, printed
     only, on); analyze times at B=8 and 32, exact and reduced; then
     build_dataset at production width (16 records x 8 windows, seed 0),
     exact fp32 and reduced rate with bf16 products, against a CPU run
     (kept/skipped, raw fields bit for bit, the first record's
     coefficients), its windows/s, statistics, a packed store read back,
     and build_dataset_from_records on two long records (errors == []);
 10. print the card's nvidia-smi name and power limit, one JSON line for
     the kernels (with their bf16 launches in each of phases 6, 7 and 8,
     counted from 0 at that phase's start), and last
     {"ok": true, "device": {...}}.
"""

import json
import statistics
from collections import Counter
import subprocess
import sys
import time

import numpy as np
import torch

N = 5760
BATCHES = (1, 8, 32)
REQUESTS = 5          # timed requests per batch size (after one warm-up)
TIMED_RUNS = 15       # kernel and yardstick timing repeats
PLAIN_RUNS = 5        # plain-version timing repeats (host-bound loops)
# published peaks of one H100 SXM: fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
FP32_TOL, BF16_TOL = 1e-5, 1.6e-2
BWD_FP32_TOL, BWD_BF16_TOL = 1e-5, 3e-2   # of max|plain| per output
# cuDNN yardstick vs the kernel's outputs, of max: fp32 1e-4; in bf16
# storage the two round h and c at other points, so bf16's forward bar
LIBRARY_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: BF16_TOL}
SERVE_REL_TOL = 1e-4  # kernel vs plain recurrence in the full model
# Training bars; PERF.md gives the measured values and the reasons. Per
# gradient leaf: max-abs over the leaf's max (floored at 1e-2 of the
# largest leaf's max); model-wide: relative L2 of the difference.
GRAD_REL_TOL = 1e-4   # runs that share a bit-identical forward
# Runs whose forwards differ by rounding: a ReLU input within rounding of 0
# falls on either side, which moves a gradient by one position's term.
KINK_REL_TOL = 1e-1   # worst leaf
KINK_L2_TOL = 2e-2    # model-wide
METRIC_REL_TOL = 1e-4  # card vs CPU losses and running statistics
PARAM_FRAC_TOL = 1e-3  # card vs CPU: share of weights more than lr/100 apart
PARAM_L2_TOL = 1e-1   # card vs CPU: rel-L2 of the parameter difference
TRAIN_STEPS = ((32, 10), (128, 5))   # (batch, steps) on one fixed batch each
# bf16 policy against fp32 on the card, of each output's max: the JAX
# package's own bar (tests/test_train.py::test_bf16_policy_forward_close_to_fp32)
BF16_FP32_REL_TOL = 0.1
# bf16 policy, card against the CPU's plain path at B=1 (PERF.md gives the
# measured value)
BF16_CPU_REL_TOL = 0.1
# bf16 train step (PERF.md gives the measured values). Kernels against the
# plain reverse wavefront on a shared forward, per gradient leaf as
# grad_report floors it, and model-wide:
BF16_GRAD_REL_TOL, BF16_GRAD_L2_TOL = 1e-1, 1e-2
# Card against the CPU on identical coefficients and noise: cuBLAS/cuDNN and
# the CPU sum bf16 products in other orders, so a product at a rounding
# boundary rounds a ulp apart, and the full-width model amplifies that ulp.
BF16_METRIC_REL_TOL = 1e-2   # losses
# The gradients' rel-L2, card against CPU, over the rel-L2 between the CPU
# and the CPU on coefficients moved by half a bf16 ulp
BF16_NUDGE_RATIO = 1.5
FIT_WINDOWS = (128, 32)   # generated training / validation windows
# Seed 0's final single-channel ReLU conv is dead on these inputs (the
# decoder heads would see zeros and their check would be vacuous); seed 2's
# is active.
INIT_SEED = 2
# Phase 9 bars (PERF.md gives the measured values): the JAX package's own.
SCAT_REL_TOL = 2e-5    # scattering, max-abs over max (tests/test_scattering.py)
PHASE_L2_TOL = 1e-4    # selected phase family between fp32 runs, rel-L2
CROSS_L2_TOL = 5e-2    # cross family between fp32 runs (chaotic in fp32)
GOLDEN_TOL = {"prod_phase": 3e-2, "prod_cross": 8e-2}   # tests/test_phase.py
ORACLE_PHASE_TOL, ORACLE_CROSS_TOL = 5e-4, 3.3e-2   # vs the float64 oracle
ETL_RECORDS, ETL_WINDOWS = 16, 8   # build-data --records 16 --windows 8
OUT_KEYS = ("z", "linear_output", "mu_pr", "logvar_pr", "mu_x", "mu_prior",
            "logvar_prior", "mu_post", "logvar_post")


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


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
    seeded CPU generator, masked to the structure `_wavefront_pack` and
    `_wavefront_xs` give them: W_eff holds only each unit's recurrent block
    and, for a unit of layer >= 1, its feed block from the unit below; the
    packed bias only layers >= 1; xs_wave only the layer-0 units' columns of
    the first S steps. The kernels read only those blocks of W_eff."""
    U = sum(depths)
    UH, K = U * h, s + max(depths) - 1
    rnd = lambda *shape: torch.randn(shape, generator=gen)
    lvec = torch.as_tensor(np.concatenate([np.arange(d) for d in depths]),
                           dtype=torch.int32)
    w_mask = torch.zeros(U, 1, 1, U, 1)
    for u in range(U):
        w_mask[u, :, :, u] = 1
        if lvec[u] > 0:
            w_mask[u - 1, :, :, u] = 1
    deep = (lvec > 0).float()[None, :, None]              # (1, U, 1)
    x_mask = torch.zeros(K, 1, 1, U, 1)
    x_mask[:s, :, :, lvec == 0] = 1
    W = (rnd(U, h, 4, U, h) * w_mask / np.sqrt(2 * h)).reshape(UH, 4 * UH)
    bias = (rnd(4, U, h) * 0.1 * deep).reshape(4 * UH)
    xs = (rnd(K, b, 4, U, h) * x_mask).reshape(K, b, 4 * UH)
    args = (W, bias, xs, rnd(b, UH) * 0.2, rnd(b, UH) * 0.2)
    return tuple(a.to(device=device, dtype=dtype) for a in args) + (
        lvec.to(device),)


def bound(kind, B, K, U, H, n_feed, itemsize):
    """(bound_ms, bound_by): the least time the card could take for one
    call, the larger of the fp32 operations the non-zero weight blocks need
    (2 * H * 4H per block, per row, per step) over the fp32 peak and the
    bytes of every input read once and every output written once over the
    memory rate."""
    UH, G = U * H, 4 * U * H
    blocks = U + n_feed
    flops = 2 * H * 4 * H * blocks * B * K
    weights = blocks * H * 4 * H
    if kind == "bwd":     # gates_seq, c_seq, c_prev_seq, dY, dh0, dc0 in
        elems = weights + K * B * G + 3 * K * B * UH + 2 * B * UH
        elems += K * B * G + 2 * B * UH      # dgates_seq, dh, dc out
    else:                 # b, xs_wave, h0, c0 in; h_seq, h_fin, c_fin out
        elems = weights + G + K * B * G + 2 * B * UH
        elems += K * B * UH + 2 * B * UH
        if kind == "fwd_res":                # gates_seq, c_seq out
            elems += K * B * G + K * B * UH
    nbytes = elems * itemsize + 4 * U        # + lvec
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def cudnn_streams(args, depths, S):
    """The yardstick: one torch.nn.LSTM (cuDNN on the card) per stream that
    computes what the wavefront computes on these operands. Layer 0 takes
    the stream's xs (S, B, 4H) through an identity input weight (the
    hoisted projection and layer 0's bias already live in xs); layer l
    takes W_hh from the recurrent block and, for l >= 1, W_ih and the bias
    from the feed block and the packed bias; h0, c0 are the wavefront's.
    Returns [(lstm, xs, h0, c0)] per stream; the port never calls this."""
    W, b, xs_wave, h0, c0, lvec = args
    U = lvec.numel()
    K, B, G = xs_wave.shape
    H = G // 4 // U
    blk = W.view(U, H, 4, U, H)
    b4 = b.view(4, U, H)
    x5 = xs_wave.view(K, B, 4, U, H)
    streams, off = [], 0
    for d in depths:
        lstm = torch.nn.LSTM(4 * H, H, num_layers=d).to(xs_wave.device,
                                                        xs_wave.dtype)
        with torch.no_grad():
            for l in range(d):
                u = off + l
                p = lambda name: getattr(lstm, f"{name}_l{l}")
                p("weight_hh").copy_(blk[u, :, :, u].reshape(H, 4 * H).t())
                p("bias_hh").zero_()
                if l:
                    p("weight_ih").copy_(
                        blk[u - 1, :, :, u].reshape(H, 4 * H).t())
                    p("bias_ih").copy_(b4[:, u].reshape(4 * H))
                else:
                    p("weight_ih").copy_(torch.eye(4 * H))
                    p("bias_ih").zero_()
        lstm.requires_grad_(False)
        lstm.flatten_parameters()
        state = lambda s: s.view(B, U, H)[:, off:off + d].transpose(
            0, 1).contiguous()
        streams.append((lstm, x5[:S, :, :, off].reshape(S, B, 4 * H)
                        .contiguous(), state(h0), state(c0)))
        off += d
    return streams


def cudnn_check(streams, depths, h_seq, h_fin, c_fin, S):
    """max-abs/max of the yardstick's top-layer ys and final (h, c) against
    the wavefront's unpacked outputs."""
    worst, off = 0.0, 0
    H = streams[0][2].shape[-1]
    for (lstm, x, hx, cx), d in zip(streams, depths):
        with torch.no_grad():
            ys, (hn, cn) = lstm(x, (hx, cx))
        top = off + d - 1
        cols = slice(off * H, (off + d) * H)
        pairs = ((ys, h_seq[d - 1:d - 1 + S, :, top * H:(top + 1) * H]),
                 (hn, h_fin[:, cols].view(-1, d, H).transpose(0, 1)),
                 (cn, c_fin[:, cols].view(-1, d, H).transpose(0, 1)))
        for lib, ours in pairs:
            ref = ours.float()
            worst = max(worst, ((lib.float() - ref).abs().max()
                                / ref.abs().max().clamp_min(1e-30)).item())
        off += d
    return worst


def cudnn_times(streams, gen):
    """CUDA-event ms of the yardstick's forward and of its backward-data
    (autograd.grad of ys, h_n, c_n with respect to xs, h0, c0 after one
    forward; the weights need no gradient), both streams back to back."""
    def fwd():
        with torch.no_grad():
            for lstm, x, hx, cx in streams:
                lstm(x, (hx, cx))
    graphs = []
    for lstm, x, hx, cx in streams:
        leaves = [t.detach().requires_grad_(True) for t in (x, hx, cx)]
        ys, (hn, cn) = lstm(leaves[0], (leaves[1], leaves[2]))
        outs = (ys, hn, cn)
        cots = tuple(torch.randn(o.shape, generator=gen).to(o) for o in outs)
        graphs.append((outs, leaves, cots))

    def bwd():
        for outs, leaves, cots in graphs:
            torch.autograd.grad(outs, leaves, cots, retain_graph=True)
    return cuda_time_ms(fwd), cuda_time_ms(bwd)


def check_residency(device):
    """The launch plans of the main path's shapes as the wrappers make
    them: rows per cluster chosen so that every cluster of U=8 CTAs is
    resident at once, by the card's cudaOccupancyMaxActiveClusters."""
    from vae_teb_tpu_torch.kernels.wavefront import (_card_resident,
                                                     _launch_plan)
    for b in (1, 8, 32, 128):
        for dtype in (torch.float32, torch.bfloat16):
            held = _card_resident(device, dtype, 8, 64)
            plan = _launch_plan(b, 8, 64, dtype, held)
            log(f"B={b} {str(dtype)[6:]}: {plan.clusters} clusters of 8 CTAs "
                f"x {plan.rows} rows, shared memory {plan.fwd_smem} / "
                f"{plan.bwd_smem} B (forward / backward); the card holds "
                f"{held(plan.rows, plan.fwd_smem, plan.bwd_smem)} such "
                f"clusters at once")


# (depths, batch, storage dtype, timed): every case checks the serving
# forward, the residual forward and the reverse wavefront against their
# plain versions; timed cases also time them, their plain versions and the
# cuDNN yardstick, and compute the bound
KERNEL_CASES = (((4, 4), 32, torch.float32, True),
                ((4, 4), 32, torch.bfloat16, True),
                ((4, 4), 128, torch.float32, True),
                ((4, 2), 32, torch.float32, False),
                ((4, 2), 32, torch.bfloat16, False),
                ((4, 4), 1, torch.float32, False))


def check_kernels(device, S=300, H=64):
    """The three kernels against their plain versions on the card, with
    times, bounds and the cuDNN yardstick; returns {(kind, depths, B,
    dtype): (err, ms, plain_ms, library_ms, (bound_ms, bound_by))}."""
    from vae_teb_tpu_torch.kernels import (wavefront_bwd, wavefront_bwd_plain,
                                           wavefront_fwd, wavefront_fwd_plain)
    gen = torch.Generator().manual_seed(4)
    results, failed = {}, []
    for depths, b, dtype, timed in KERNEL_CASES:
        fp32 = dtype == torch.float32
        tol = FP32_TOL if fp32 else BF16_TOL
        btol = BWD_FP32_TOL if fp32 else BWD_BF16_TOL
        name = str(dtype)[6:]
        label = f"{'x'.join(map(str, depths))} layers B={b} S={S} {name}"
        args = recurrence_inputs(gen, b, S, H, depths, dtype, device)
        W, _, xs, h0, c0, lvec = args
        K, U = xs.shape[0], lvec.numel()
        n_feed = int((lvec > 0).sum())
        time_pair = (lambda f, g: (cuda_time_ms(f), cuda_time_ms(g, PLAIN_RUNS))
                     ) if timed else (lambda f, g: (None, None))

        got = wavefront_fwd(*args, S)
        want = wavefront_fwd_plain(*args, S)
        torch.cuda.synchronize()
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        ms, plain_ms = time_pair(lambda: wavefront_fwd(*args, S),
                                 lambda: wavefront_fwd_plain(*args, S))
        log(f"serving forward {label}: max_abs_err={err!r} (tol {tol}) "
            f"kernel {ms!r} ms, plain {plain_ms!r} ms")
        if not err <= tol:
            failed.append(f"serving forward {label}: {err} > {tol}")
        fwd_out = got
        results[("fwd", depths, b, dtype)] = [err, ms, plain_ms]

        got = wavefront_fwd(*args, S, with_residuals=True)
        want = wavefront_fwd_plain(*args, S, with_residuals=True)
        torch.cuda.synchronize()
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        # the stored pre-activation gates reach |g| ~ 8: held to tol *
        # max(1, |g|), two storage ulps at each value's scale
        scaled = max(((g.float() - w.float()).abs() / (
            w.float().abs().clamp_min(1.0) if i == 3 else 1.0)
        ).max().item() for i, (g, w) in enumerate(zip(got, want)))
        ms, plain_ms = time_pair(
            lambda: wavefront_fwd(*args, S, with_residuals=True),
            lambda: wavefront_fwd_plain(*args, S, with_residuals=True))
        log(f"residual forward {label}: max_abs_err={err!r}, scaled "
            f"{scaled!r} (tol {tol}) kernel {ms!r} ms, plain {plain_ms!r} ms")
        if not scaled <= tol:
            failed.append(f"residual forward {label}: {scaled} > {tol}")
        results[("fwd_res", depths, b, dtype)] = [err, ms, plain_ms]

        _, _, _, gates_seq, c_seq = want
        c_prev = torch.cat([c0[None], c_seq[:-1]])
        rnd = lambda *shape: torch.randn(shape, generator=gen).to(
            device=device, dtype=dtype)
        UH = U * H
        bargs = (W, gates_seq, c_seq, c_prev, rnd(K, b, UH), rnd(b, UH),
                 rnd(b, UH), lvec)
        got = wavefront_bwd(*bargs, S)
        want = wavefront_bwd_plain(*bargs, S)
        torch.cuda.synchronize()
        abs_err, rel = 0.0, 0.0
        for g, w in zip(got, want):
            e = (g.float() - w.float()).abs().max().item()
            abs_err = max(abs_err, e)
            rel = max(rel, e / max(w.float().abs().max().item(), 1e-30))
        ms, plain_ms = time_pair(lambda: wavefront_bwd(*bargs, S),
                                 lambda: wavefront_bwd_plain(*bargs, S))
        log(f"reverse wavefront {label}: max_abs_err={abs_err!r}, "
            f"max-abs/max|plain| {rel!r} (tol {btol}) kernel {ms!r} ms, "
            f"plain {plain_ms!r} ms")
        if not rel <= btol:
            failed.append(f"reverse wavefront {label}: {rel} > {btol}")
        results[("bwd", depths, b, dtype)] = [abs_err, ms, plain_ms]

        if not timed:
            continue
        lib = {"fwd": None, "fwd_res": None, "bwd": None}
        try:
            streams = cudnn_streams(args, depths, S)
            lib_err = cudnn_check(streams, depths, *fwd_out, S)
            lib_tol = LIBRARY_REL_TOL[dtype]
            log(f"cuDNN LSTM yardstick {label}: ys, h_n, c_n against the "
                f"kernel max-abs/max {lib_err!r} (tol {lib_tol})")
            if not lib_err <= lib_tol:
                failed.append(f"cuDNN yardstick {label}: {lib_err} > "
                              f"{lib_tol}")
            lib_fwd, lib_bwd = cudnn_times(streams, gen)
            lib = {"fwd": lib_fwd, "fwd_res": lib_fwd, "bwd": lib_bwd}
        except RuntimeError as e:     # a type cuDNN's LSTM does not take
            log(f"cuDNN LSTM yardstick {label}: not available ({e})")
        for kind in ("fwd", "fwd_res", "bwd"):
            bnd = bound(kind, b, K, U, H, n_feed, xs.element_size())
            results[(kind, depths, b, dtype)] += [lib[kind], bnd]
            _, ms, _ = results[(kind, depths, b, dtype)][:3]
            log(f"{kind} {label}: kernel {ms!r} ms, cuDNN {lib[kind]!r} ms, "
                f"bound {bnd[0]!r} ms ({bnd[1]}), {bnd[0] / ms:.4%} of the "
                f"bound")
    if failed:
        raise AssertionError("kernels disagree with their plain versions "
                             "or the yardstick: " + "; ".join(failed))
    return results


def serve(device):
    from vae_teb_tpu_torch import (InferenceServer, SeqVaeTeb,
                                   init_parameters, production_frontend)
    from vae_teb_tpu_torch.kernels import wavefront_fwd, wavefront_fwd_plain

    t0 = time.perf_counter()
    model = init_parameters(SeqVaeTeb(), seed=INIT_SEED)
    server = InferenceServer(model, production_frontend(device), device)
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
    from vae_teb_tpu_torch import InferenceServer, production_frontend
    cpu = InferenceServer(copy.deepcopy(server.model).cpu(),
                          production_frontend("cpu"), "cpu")
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


def grad_report(got, want):
    """(worst per-leaf error, its leaf, model-wide relative L2) of the
    gradients `got` against `want`. A leaf's error is its max-abs
    difference over its largest entry, that scale floored at 1e-2 of the
    largest entry of any leaf (leaves whose gradient cancels; see
    PERF.md)."""
    top = max(w.abs().max().item() for w in want.values())
    worst, leaf, num, den = 0.0, None, 0.0, 0.0
    for k, w in want.items():
        d = got[k].float() - w.float()
        err = d.abs().max().item() / max(w.abs().max().item(), 1e-2 * top)
        if err >= worst:
            worst, leaf = err, k
        num += d.square().sum().item()
        den += w.float().square().sum().item()
    return worst, leaf, (num / den) ** 0.5


def train_loop(trainer, frontend, batch_of, fields, beta, label):
    """TRAIN_STEPS: at each (B, steps), `steps` train steps on one fixed
    batch of raw windows through the frontend on the card. Checks finite
    metrics, a falling loss at the first B, and that every step launched
    the residual forward and the reverse wavefront of the model's storage
    type once each (`wavefront_fwd_res_{f32,bf16}`, `wavefront_bwd_...`)
    and no other kernel entry. Returns (steps, {B: (median ms without the
    frontend, with it)})."""
    from vae_teb_tpu_torch.kernels import wavefront_bwd, wavefront_fwd
    kind = "bf16" if trainer.model.dtype == torch.bfloat16 else "f32"
    expect = {f"wavefront_fwd_res_{kind}": 1, f"wavefront_bwd_{kind}": 1}
    device = trainer.device
    steps, times = 0, {}
    for b, n_steps in TRAIN_STEPS:
        fhr, up, y_raw = batch_of(b)
        torch.cuda.reset_peak_memory_stats(device)
        totals, with_fe, without_fe = [], [], []
        for step in range(n_steps):
            before = (Counter(wavefront_fwd.entry_launches),
                      Counter(wavefront_bwd.entry_launches))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            coeffs = frontend(fhr, up)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            metrics = trainer.train_step(fields(coeffs, y_raw), beta)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            steps += 1
            metrics = {k: v.item() for k, v in metrics.items()}
            launched = dict((wavefront_fwd.entry_launches - before[0])
                            + (wavefront_bwd.entry_launches - before[1]))
            if launched != expect:
                raise AssertionError(f"{label} step B={b} #{step}: kernel "
                                     f"entries launched {launched}, "
                                     f"expected {expect}")
            if not all(np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"{label} step B={b} #{step}: "
                                     f"non-finite metrics {metrics}")
            totals.append(metrics["total_loss"])
            if step:                                   # step 0 warms up
                with_fe.append(t2 - t0)
                without_fe.append(t2 - t1)
            log(f"{label} B={b} step {step}: " + ", ".join(
                f"{k} {v!r}" for k, v in sorted(metrics.items())))
        peak = torch.cuda.max_memory_allocated(device)
        med_with, med_without = (statistics.median(with_fe),
                                 statistics.median(without_fe))
        times[b] = (med_without * 1e3, med_with * 1e3)
        log(f"{label} B={b}: median step {med_without * 1e3!r} ms without "
            f"the frontend, {med_with * 1e3!r} ms with it, over "
            f"{n_steps - 1} steps after a warm-up; {b / med_with!r} "
            f"windows/s with the frontend ({b / med_without!r} without); "
            f"peak device memory {peak} bytes")
        if b == TRAIN_STEPS[0][0] and not totals[-1] < totals[0]:
            raise AssertionError(f"{label}: fixed-batch total_loss did not "
                                 f"fall over {n_steps} steps: {totals}")
    return steps, times


def train(device):
    """The training phases; returns the main path's launch counts."""
    import copy
    from vae_teb_tpu_torch import (SeqVaeTeb, Trainer, TrainerConfig,
                                   WindowFrontend, init_parameters,
                                   production_frontend)
    from vae_teb_tpu_torch.kernels import (wavefront_bwd, wavefront_bwd_plain,
                                           wavefront_fwd, wavefront_fwd_plain)

    t0 = time.perf_counter()
    model = init_parameters(SeqVaeTeb(), seed=INIT_SEED)
    cfg = TrainerConfig()
    trainer = Trainer(model, cfg, device)
    frontend = WindowFrontend(production_frontend(device))
    log(f"training set-up (init, optimizer, frontend plan): "
        f"{time.perf_counter() - t0:.2f} s; TrainerConfig {cfg}")
    gen = torch.Generator(device=device).manual_seed(5)
    beta = trainer.beta_fn(0)   # constant kld_beta, 1e-5

    raw_len = model.decoder.raw_len          # 16 S
    latent = (raw_len // 16, 32)             # (S, latent width) of eps

    def batch_of(b):
        x = torch.randn((2, b, N), generator=gen, device=device)
        return x[0], x[1], torch.randn((b, raw_len), generator=gen,
                                       device=device)

    def fields(coeffs, y_raw):
        return dict(zip(("fhr_st", "fhr_ph", "fhr_up_ph"), coeffs), fhr=y_raw)

    wavefront_fwd.launches = 0
    wavefront_fwd.residual_launches = 0
    wavefront_bwd.launches = 0
    steps, times = train_loop(trainer, frontend, batch_of, fields, beta,
                              "train")
    counts = (wavefront_fwd.residual_launches, wavefront_bwd.launches)
    if counts != (steps, steps) or wavefront_fwd.launches:
        raise AssertionError(f"{steps} train steps launched the residual "
                             f"forward {counts[0]}, the backward {counts[1]} "
                             f"and the serving forward "
                             f"{wavefront_fwd.launches} times")
    log(f"train launches: residual forward {counts[0]}, backward "
        f"{counts[1]} in {steps} steps")

    failed = []

    def check(name, value, bar):
        if not value <= bar:
            failed.append(f"{name}: {value!r} > {bar!r}")

    # one B=8 step from the same weights and noise: the kernels against
    # (a) the plain reverse wavefront behind the kernel forward, so both
    # runs share a bit-identical forward, and (b) the plain recurrence for
    # both directions (autograd differentiates the plain loop), whose
    # forward differs by rounding
    fhr, up, y_raw = batch_of(8)
    batch = fields(frontend(fhr, up), y_raw)
    eps = torch.randn((8,) + latent, generator=gen, device=device)
    wavefront_module = sys.modules["vae_teb_tpu_torch.kernels.wavefront"]
    grads = {}
    for name in ("kernels", "plain backward", "plain recurrence"):
        m = copy.deepcopy(model)
        if name == "plain recurrence":
            m.recurrence = wavefront_fwd_plain
        if name == "plain backward":
            wavefront_module.wavefront_bwd = wavefront_bwd_plain
        try:
            Trainer(m, cfg, device).train_step(batch, beta, eps=eps)
        finally:
            wavefront_module.wavefront_bwd = wavefront_bwd
        grads[name] = {k: p.grad for k, p in m.named_parameters()}
        del m
    for name, bar, l2_bar in (("plain backward", GRAD_REL_TOL, GRAD_REL_TOL),
                              ("plain recurrence", KINK_REL_TOL, KINK_L2_TOL)):
        worst, leaf, l2 = grad_report(grads["kernels"], grads[name])
        log(f"train step kernels vs {name} (B=8): {len(grads[name])} "
            f"gradient leaves, worst max-abs/max {worst!r} ({leaf}; bar "
            f"{bar}), model-wide rel-L2 {l2!r} (bar {l2_bar})")
        check(f"kernels vs {name}: worst leaf {leaf}", worst, bar)
        check(f"kernels vs {name}: rel-L2", l2, l2_bar)
    del grads

    # one B=2 step on identical coefficients and noise on the CPU
    fhr, up, y_raw = batch_of(2)
    batch = fields(frontend(fhr, up), y_raw)
    eps = torch.randn((2,) + latent, generator=gen, device=device)
    gpu_model, cpu_model = copy.deepcopy(model), copy.deepcopy(model).cpu()
    before = [p.detach().clone() for p in cpu_model.parameters()]
    m_gpu = Trainer(gpu_model, cfg, device).train_step(batch, beta, eps=eps)
    m_cpu = Trainer(cpu_model, cfg, "cpu").train_step(
        {k: v.cpu() for k, v in batch.items()}, beta, eps=eps.cpu())
    rel = {k: abs(m_gpu[k].item() / m_cpu[k].item() - 1) for k in m_cpu}
    norm_err = rel.pop("grad_norm")   # a model-wide L2: moves with kinks
    loss_err = max(rel.values())
    check("card vs CPU losses", loss_err, METRIC_REL_TOL)
    check("card vs CPU grad_norm", norm_err, KINK_L2_TOL)
    worst, leaf, l2 = grad_report(
        {k: p.grad.cpu() for k, p in gpu_model.named_parameters()},
        {k: p.grad for k, p in cpu_model.named_parameters()})
    check(f"card vs CPU gradients: worst leaf {leaf}", worst, KINK_REL_TOL)
    check("card vs CPU gradients: rel-L2", l2, KINK_L2_TOL)
    # updated parameters: Adam's first step moves each weight by about
    # lr * sign(g), so an element whose gradient is rounding noise, or
    # sits at a ReLU kink, can step the other way (up to 2 lr apart)
    diff = [p.detach().cpu() - q.detach() for p, q in
            zip(gpu_model.parameters(), cpu_model.parameters())]
    upd = [q.detach() - b for q, b in zip(cpu_model.parameters(), before)]
    p_err = max(d.abs().max().item() for d in diff)
    n = sum(d.numel() for d in diff)
    p_frac = sum((d.abs() > 1e-2 * cfg.lr).sum().item() for d in diff) / n
    p_l2 = (sum(d.square().sum().item() for d in diff)
            / sum(u.square().sum().item() for u in upd)) ** 0.5
    check("card vs CPU parameters: share of elements more than lr/100 "
          "apart", p_frac, PARAM_FRAC_TOL)
    check("card vs CPU parameters: rel-L2 of the update", p_l2, PARAM_L2_TOL)
    s_err = max(((a.cpu() - c).abs().max() / c.abs().max().clamp_min(1e-30)
                 ).item() for a, c in zip(gpu_model.buffers(),
                                          cpu_model.buffers()))
    check("card vs CPU running statistics", s_err, METRIC_REL_TOL)
    log(f"train step card vs CPU (B=2, identical coefficients and noise): "
        f"losses rel {loss_err!r}, grad_norm rel {norm_err!r}; gradients "
        f"worst max-abs/max {worst!r} "
        f"({leaf}), rel-L2 {l2!r}; updated parameters max-abs {p_err!r}, "
        f"share more than lr/100 apart {p_frac!r} of {n}, rel-L2 of the "
        f"update {p_l2!r}; running statistics max-abs/max {s_err!r}")
    if failed:
        raise AssertionError("training checks failed:\n" + "\n".join(failed))
    return counts, times


def bf16_forward(device):
    """The bf16 compute policy's forward: full-width SeqVaeTeb(dtype=bf16)
    on the smoke's seeded weights against the same weights in fp32 on the
    card (eval mode, B=32, production-frontend coefficients), and B=1
    against the CPU's plain path in the same policy. Returns the kernel
    entries launched by the bf16 forward."""
    import copy
    from vae_teb_tpu_torch import (SeqVaeTeb, WindowFrontend,
                                   init_parameters, production_frontend)
    from vae_teb_tpu_torch.kernels import wavefront_fwd
    frontend = WindowFrontend(production_frontend(device))
    gen = torch.Generator(device=device).manual_seed(8)
    x = torch.randn((2, 32, N), generator=gen, device=device)
    coeffs = frontend(x[0], x[1])
    m32 = init_parameters(SeqVaeTeb(), seed=INIT_SEED)
    m16 = SeqVaeTeb(dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    m32, m16 = m32.to(device).eval(), m16.to(device).eval()
    with torch.inference_mode():
        want = m32(*coeffs, deterministic=True)
        wavefront_fwd.entry_launches.clear()
        got = m16(*coeffs, deterministic=True)
        torch.cuda.synchronize()
        launched = dict(wavefront_fwd.entry_launches)
    failed = []
    worst = {}
    for k in OUT_KEYS:
        if got[k].dtype != torch.bfloat16 or got[k].shape != want[k].shape:
            failed.append(f"{k}: {got[k].dtype} {tuple(got[k].shape)}")
            continue
        if not torch.isfinite(got[k]).all():
            failed.append(f"{k}: non-finite values")
        worst[k] = ((got[k].float() - want[k]).abs().max()
                    / want[k].abs().max().clamp_min(1e-30)).item()
    log(f"bf16 policy vs fp32 (B=32, eval): max-abs/max per output "
        f"{worst} (tol {BF16_FP32_REL_TOL}); kernel entries {launched}")
    failed += [f"{k}: {v} > {BF16_FP32_REL_TOL}" for k, v in worst.items()
               if not v <= BF16_FP32_REL_TOL]
    if launched != {"wavefront_fwd_bf16": 1}:
        failed.append(f"bf16 forward launched {launched}, expected "
                      f"wavefront_fwd_bf16 once")

    cpu = copy.deepcopy(m16).cpu()
    one = [c[:1] for c in coeffs]
    with torch.inference_mode():
        card = m16(*one, deterministic=True)
        plain = cpu(*[c.cpu() for c in one], deterministic=True)
    vs_cpu = {k: ((card[k].float().cpu() - plain[k].float()).abs().max()
                  / plain[k].float().abs().max().clamp_min(1e-30)).item()
              for k in OUT_KEYS}
    log(f"bf16 policy card vs CPU (B=1, identical coefficients): "
        f"max-abs/max per output {vs_cpu} (tol {BF16_CPU_REL_TOL})")
    failed += [f"card vs CPU {k}: {v} > {BF16_CPU_REL_TOL}"
               for k, v in vs_cpu.items() if not v <= BF16_CPU_REL_TOL]
    if failed:
        raise AssertionError("bf16 forward checks failed:\n"
                             + "\n".join(failed))
    return launched


def train_bf16(device, fp32_times):
    """The production training policy: TrainerConfig(precision="bf16",
    moment_dtype="bf16") on the full-width model, TRAIN_STEPS with the
    frontend in the step; prints the median step beside the fp32 phase's.
    Then one B=8 step against the plain reverse wavefront on the card and
    against the CPU in the same policy. Returns the kernel entries launched
    by the training steps."""
    import copy
    from vae_teb_tpu_torch import (SeqVaeTeb, Trainer, TrainerConfig,
                                   WindowFrontend, init_parameters,
                                   production_frontend)
    from vae_teb_tpu_torch.kernels import (wavefront_bwd, wavefront_bwd_plain,
                                           wavefront_fwd)
    cfg = TrainerConfig(precision="bf16", moment_dtype="bf16")
    model = SeqVaeTeb(dtype=cfg.model_dtype())
    model.load_state_dict(init_parameters(SeqVaeTeb(), seed=INIT_SEED)
                          .state_dict())
    trainer = Trainer(model, cfg, device)
    frontend = WindowFrontend(production_frontend(device))
    gen = torch.Generator(device=device).manual_seed(5)
    raw_len = model.decoder.raw_len

    def batch_of(b):
        x = torch.randn((2, b, N), generator=gen, device=device)
        return x[0], x[1], torch.randn((b, raw_len), generator=gen,
                                       device=device)

    def fields(coeffs, y_raw):
        return dict(zip(("fhr_st", "fhr_ph", "fhr_up_ph"), coeffs), fhr=y_raw)

    wavefront_fwd.entry_launches.clear()
    wavefront_bwd.entry_launches.clear()
    steps, times = train_loop(trainer, frontend, batch_of, fields,
                              trainer.beta_fn(0), "train bf16")
    launched = Counter(wavefront_fwd.entry_launches)
    launched.update(wavefront_bwd.entry_launches)
    want = {"wavefront_fwd_res_bf16": steps, "wavefront_bwd_bf16": steps}
    moments = {str(st["mu"].dtype) for st in trainer.optimizer.state.values()}
    log(f"train bf16 launches {dict(launched)} in {steps} steps; Adam "
        f"moments stored as {moments}")
    if dict(launched) != want or moments != {"torch.bfloat16"}:
        raise AssertionError(f"bf16 training launched {dict(launched)} "
                             f"(expected {want}), moments {moments}")
    for b in times:
        log(f"median train step B={b} (same card, this run): bf16 policy "
            f"{times[b][0]!r} ms without the frontend, {times[b][1]!r} ms "
            f"with it; fp32 {fp32_times[b][0]!r} / {fp32_times[b][1]!r} ms")

    # one B=8 step from the trained weights in the same policy: (a) on the
    # card with the plain reverse wavefront behind the kernel forward, so
    # both runs share a bit-identical forward; (b) on the CPU, and on the
    # CPU with the coefficients moved by half a bf16 ulp, which measures how
    # far the bf16 gradient moves under rounding-sized changes alone
    fhr, up, y_raw = batch_of(8)
    coeffs = frontend(fhr, up)
    nudged = [c * (1 + 2 ** -9 * torch.randn(c.shape, generator=gen,
                                              device=device)) for c in coeffs]
    eps = torch.randn((8, raw_len // 16, 32), generator=gen, device=device)
    wavefront_module = sys.modules["vae_teb_tpu_torch.kernels.wavefront"]
    grads, metrics = {}, {}
    for name in ("kernels", "plain backward", "CPU", "CPU nudged"):
        on_cpu = name.startswith("CPU")
        m = copy.deepcopy(model).to("cpu" if on_cpu else device)
        batch = fields(nudged if name == "CPU nudged" else coeffs, y_raw)
        if on_cpu:
            batch = {k: v.cpu() for k, v in batch.items()}
        if name == "plain backward":
            wavefront_module.wavefront_bwd = wavefront_bwd_plain
        try:
            metrics[name] = Trainer(
                m, cfg, "cpu" if on_cpu else device).train_step(
                    batch, trainer.beta_fn(0),
                    eps=eps.cpu() if on_cpu else eps)
        finally:
            wavefront_module.wavefront_bwd = wavefront_bwd
        grads[name] = {k: p.grad.cpu() for k, p in m.named_parameters()}
        del m
    dtypes = {g.dtype for g in grads["kernels"].values()}
    worst, leaf, l2 = grad_report(grads["kernels"], grads["plain backward"])
    loss_err = max(abs(metrics["kernels"][k].item()
                       / metrics["CPU"][k].item() - 1)
                   for k in metrics["CPU"] if k != "grad_norm")
    _, _, l2_cpu = grad_report(grads["kernels"], grads["CPU"])
    _, _, l2_nudge = grad_report(grads["CPU nudged"], grads["CPU"])
    log(f"train bf16 step kernels vs plain backward (B=8, shared forward): "
        f"gradients {dtypes}, worst max-abs/max {worst!r} ({leaf}; bar "
        f"{BF16_GRAD_REL_TOL}), rel-L2 {l2!r} (bar {BF16_GRAD_L2_TOL})")
    log(f"train bf16 step card vs CPU (B=8, identical coefficients and "
        f"noise): losses rel {loss_err!r} (bar {BF16_METRIC_REL_TOL}); "
        f"gradient rel-L2 {l2_cpu!r}, against {l2_nudge!r} between the CPU "
        f"and the CPU on coefficients moved by half a bf16 ulp (bar "
        f"{BF16_NUDGE_RATIO} times that); grad_norm card "
        f"{metrics['kernels']['grad_norm'].item()!r}, CPU "
        f"{metrics['CPU']['grad_norm'].item()!r}, CPU nudged "
        f"{metrics['CPU nudged']['grad_norm'].item()!r}")
    failed = [f"{name}: {v!r} > {bar!r}" for name, v, bar in (
        (f"kernels vs plain backward: worst leaf {leaf}", worst,
         BF16_GRAD_REL_TOL),
        ("kernels vs plain backward: rel-L2", l2, BF16_GRAD_L2_TOL),
        ("card vs CPU losses", loss_err, BF16_METRIC_REL_TOL),
        ("card vs CPU gradient rel-L2", l2_cpu, BF16_NUDGE_RATIO * l2_nudge))
        if not v <= bar]
    if dtypes != {torch.float32}:
        failed.append(f"gradient dtypes {dtypes}")
    if failed:
        raise AssertionError("bf16 step checks failed:\n"
                             + "\n".join(failed))
    return launched


class _Windows:
    """Coefficient arrays in raw (C, S) layout, read as a dataset by
    PackedWindowStore.build."""

    def __init__(self, arrays):
        self.arrays = arrays
        self.stats, self.trim_minutes, self.raw_layout = None, None, True

    def __len__(self):
        return len(self.arrays["fhr"])

    def read_batch(self, indices):
        idx = list(indices)
        return {k: v[idx] for k, v in self.arrays.items()}


def _field_stats(arrays):
    """Normalization statistics over the generated training set, after the
    production transforms (log on fhr_st's channels 1.., asinh on the phase
    families), float64 moments per channel."""
    from vae_teb_tpu_torch.data import (apply_channel_transforms,
                                        default_field_stats)
    out = {"fhr": default_field_stats("fhr", arrays["fhr"].mean(),
                                      arrays["fhr"].var())}
    for name in ("fhr_st", "fhr_ph", "fhr_up_ph"):
        x = arrays[name].astype(np.float64)
        probe = default_field_stats(name, np.zeros(x.shape[1]),
                                    np.ones(x.shape[1]))
        x = apply_channel_transforms(x, probe.log_channels,
                                     probe.asinh_channels, probe.log_epsilon)
        out[name] = default_field_stats(name, x.mean(axis=(0, 2)),
                                        x.var(axis=(0, 2)))
    return out


def fit_phase(device):
    """`cli train`'s function on the card: seeded windows through the
    frontend into two packed stores (raw layout), a RunConfig built in code
    (bf16, bf16 moments, batch 32, accumulate 2, prefetch 2, keep 2, 3
    epochs, device normalization), run_training, then a resume for a 4th
    epoch. Returns the kernel entries launched."""
    import json
    import os
    import tempfile
    from vae_teb_tpu_torch import Trainer, WindowFrontend, production_frontend
    from vae_teb_tpu_torch.cli import run_training
    from vae_teb_tpu_torch.data import PackedWindowStore
    from vae_teb_tpu_torch.kernels import wavefront_bwd, wavefront_fwd
    from vae_teb_tpu_torch.train import (Checkpointer, DatasetConfig,
                                         ModelConfig, RunConfig,
                                         TrainerConfig)
    from vae_teb_tpu_torch.utils import setup_logging
    setup_logging(capture_root=False)
    frontend = WindowFrontend(production_frontend(device))
    gen = torch.Generator(device=device).manual_seed(9)

    def windows(n):
        """n seeded raw windows -> raw-layout coefficients and, as the
        target fhr, the FHR window trimmed to the 16 S samples the
        coefficients cover (the middle 4800 of 5760)."""
        parts = {k: [] for k in ("fhr_st", "fhr_ph", "fhr_up_ph", "fhr")}
        for _ in range(n // 32):
            x = torch.randn((2, 32, N), generator=gen, device=device)
            coeffs = frontend(x[0], x[1])
            for k, c in zip(("fhr_st", "fhr_ph", "fhr_up_ph"), coeffs):
                parts[k].append(c.transpose(1, 2).cpu().numpy())
            trim = (N - 16 * coeffs[0].shape[1]) // 2
            parts["fhr"].append(x[0, :, trim:N - trim].cpu().numpy())
        return {k: np.ascontiguousarray(np.concatenate(v))
                for k, v in parts.items()}

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_scratch")
    os.makedirs(root, exist_ok=True)
    seen = []
    step_fn = Trainer.train_step

    def spy(self, batch, beta, eps=None):
        seen.append({k: (type(v).__name__, getattr(v, "device", None))
                     for k, v in batch.items()})
        return step_fn(self, batch, beta, eps)

    with tempfile.TemporaryDirectory(dir=root) as tmp:
        train_arrays, val_arrays = windows(FIT_WINDOWS[0]), windows(
            FIT_WINDOWS[1])
        stores = []
        for name, arrays in (("train", train_arrays), ("val", val_arrays)):
            PackedWindowStore.build(_Windows(arrays), os.path.join(tmp, name))
            stores.append(os.path.join(tmp, name))
        cfg = RunConfig(
            tag="smoke", out_dir_base=os.path.join(tmp, "runs"),
            model=ModelConfig(input_channels=train_arrays["fhr_up_ph"].shape[1],
                              n_scattering=train_arrays["fhr_st"].shape[1],
                              n_phase=train_arrays["fhr_ph"].shape[1]),
            trainer=TrainerConfig(precision="bf16", moment_dtype="bf16",
                                  accumulate_grad_batches=2, prefetch=2,
                                  epochs=3, seed=INIT_SEED),
            dataset=DatasetConfig(train_paths=stores[:1],
                                  validation_paths=stores[1:],
                                  batch_size=32, eval_batch_size=32))
        cfg.checkpoints.keep = 2
        stats = _field_stats(train_arrays)
        wavefront_fwd.entry_launches.clear()
        wavefront_bwd.entry_launches.clear()
        Trainer.train_step = spy
        try:
            t0 = time.perf_counter()
            first = run_training(cfg, device, normalize_stats=stats)
            t1 = time.perf_counter()
            saved = first.state_dict()
            ckpt = Checkpointer(os.path.join(cfg.run_dir(),
                                             "model_checkpoints"), keep=2)
            restored = ckpt.restore(step=2)
            cfg.trainer.epochs = 4
            t2 = time.perf_counter()
            second = run_training(cfg, device, resume=True,
                                  normalize_stats=stats)
            t3 = time.perf_counter()
        finally:
            Trainer.train_step = step_fn
        launched = Counter(wavefront_fwd.entry_launches)
        launched.update(wavefront_bwd.entry_launches)
        with open(os.path.join(ckpt.directory, "index.json")) as f:
            index = json.load(f)
        on_disk = sorted(d for d in os.listdir(ckpt.directory)
                         if d.startswith("step_"))

    failed = []
    hist = second.history
    n_steps = FIT_WINDOWS[0] // 32
    log(f"fit: 3 epochs in {t1 - t0:.2f} s, resumed 4th in {t3 - t2:.2f} s "
        f"(set-up included); history epochs {hist['epoch']}, train "
        f"{hist['train/total_loss']}, val {hist['val/total_loss']}, win/s "
        f"{hist['windows_per_sec']}")
    if hist["epoch"] != [0, 1, 2, 3]:
        failed.append(f"history epochs {hist['epoch']}")
    for key in ("train/total_loss", "val/total_loss", "windows_per_sec"):
        if len(hist[key]) != 4 or not all(np.isfinite(v) and (
                v > 0 or key != "windows_per_sec") for v in hist[key]):
            failed.append(f"history {key}: {hist[key]}")
    metrics = dict(zip(hist["epoch"], hist["val/total_loss"]))
    keep = {3} | set(sorted(metrics, key=metrics.get)[:2])
    kept = {e["step"] for e in index}
    log(f"fit: index.json steps {sorted(kept)}, directories {on_disk}; "
        f"expected best 2 by val total_loss plus the latest: {sorted(keep)}")
    if kept != keep or on_disk != [f"step_{k:08d}" for k in sorted(keep)]:
        failed.append(f"checkpoints kept {sorted(kept)} / {on_disk}, "
                      f"expected {sorted(keep)}")
    diff = [k for k, v in saved["model"].items()
            if not torch.equal(v.cpu(), restored["model"][k])]
    mom = saved["optimizer"]["inner"]
    mom_diff = sum(not torch.equal(a.cpu(), b) for name in ("mu", "nu")
                   for a, b in zip(mom[name], restored["optimizer"]["inner"]
                                   [name]))
    log(f"fit: checkpoint of epoch 2 against the trainer that wrote it: "
        f"{len(diff)} of {len(saved['model'])} model entries and {mom_diff} "
        f"moments differ; moments stored as "
        f"{restored['optimizer']['inner']['mu'][0].dtype}")
    if diff or mom_diff or restored["step"] != saved["step"]:
        failed.append(f"restored state differs: {diff[:5]}, {mom_diff} "
                      f"moments, step {restored['step']} vs {saved['step']}")
    counts = (first.optimizer.inner.count, second.optimizer.inner.count,
              first.step, second.step)
    want = (3 * n_steps // 2, 4 * n_steps // 2, 3 * n_steps, 4 * n_steps)
    log(f"fit: optimizer updates / train steps after 3 epochs "
        f"{counts[0]} / {counts[2]}, after the resumed 4th {counts[1]} / "
        f"{counts[3]} (expected {want})")
    if counts != want:
        failed.append(f"optimizer count and steps {counts}, expected {want}")
    devices = {str(v[1]) for batch in seen for v in batch.values()}
    types = {v[0] for batch in seen for v in batch.values()}
    log(f"fit: {len(seen)} train steps took batches of {types} on {devices}")
    if len(seen) != 4 * n_steps or types != {"Tensor"} or any(
            not d.startswith("cuda") for d in devices):
        failed.append(f"prefetch delivered {types} on {devices} in "
                      f"{len(seen)} steps")
    want = {"wavefront_fwd_res_bf16": 4 * n_steps,
            "wavefront_bwd_bf16": 4 * n_steps,
            "wavefront_fwd_bf16": 4 * FIT_WINDOWS[1] // 32}
    log(f"fit: kernel entries launched {dict(launched)} (expected {want}: "
        f"one residual forward and one backward a train step, one forward "
        f"a validation batch)")
    if dict(launched) != want:
        failed.append(f"fit launched {dict(launched)}, expected {want}")
    if failed:
        raise AssertionError("fit checks failed:\n" + "\n".join(failed))
    return launched


def fp64_phase_oracle(sc, x64, idx, cross):
    """Float64 NumPy oracle of the exact accelerated-correlation chain (pad
    -> band -> principal-branch acceleration -> conjugate product -> phi
    low-pass -> decimate) for the pairs `idx` of the port's frontend `sc`
    on windows x64 (B, 2, N): channel 0 accelerated, against channel 1
    (cross) or itself. A copy of the JAX suite's oracle
    (tests/test_phase.py::_fp64_phase_oracle)."""
    from vae_teb_tpu_torch.ops.scattering import reflect_pad_indices
    N, pl, dec = sc.N, sc.pad_left, sc.decimation
    psi = np.asarray(sc.fb.psi1, np.float64)
    phi = np.asarray(sc.fb.phi_levels[0], np.float64)
    pad = reflect_pad_indices(N, sc.pad_left, sc.pad_right)

    def bands(sig, rows):
        spec = np.fft.fft(sig[..., pad])
        return np.fft.ifft(spec[:, None, :] * psi[rows])[..., pl:pl + N]

    idx = list(idx)
    pw = np.asarray(sc.pairs.powers[idx], np.float64)
    zi = bands(x64[:, 0], sc.pairs.i_idx[idx])
    zj = bands(x64[:, 1] if cross else x64[:, 0], sc.pairs.j_idx[idx])
    a = np.abs(zi) * np.exp(1j * pw[None, :, None] * np.angle(zi))
    spec = np.fft.fft((a * np.conj(zj))[..., pad])
    keep = sc.N_padded // dec
    s = np.fft.ifft(spec[..., :keep] * phi[:keep]).real
    start = pl // dec
    return s[..., start:min(start + N // dec, keep)]


def frontend_etl_phase(device):
    """The exact frontend, order-2 scattering and the dataset ETL on the
    card (phase 9). Returns the numbers PERF.md reports."""
    import os
    import tempfile
    from vae_teb_tpu_torch.data import (DatasetStatsCalculator,
                                        PackedWindowStore, build_dataset,
                                        build_dataset_from_records,
                                        synthetic_fhr_up, synthetic_records)
    from vae_teb_tpu_torch.ops import PhaseScattering1D, Scattering1D
    cpu = torch.device("cpu")
    failed, report = [], {}
    rel_l2 = lambda a, b: float(np.linalg.norm(np.float64(a) - b)
                                / np.linalg.norm(np.float64(b)))
    max_rel = lambda a, b: float(np.abs(np.float64(a) - b).max()
                                 / np.abs(np.float64(b)).max())
    golden = lambda name: np.load(f"tests/golden/{name}.npz")

    def check(label, value, bar):
        log(f"frontend: {label} {value!r} (bar {bar})")
        if not value <= bar:
            failed.append(f"{label} {value!r} > {bar}")

    def families(out, keys=("scattering", "phase_corr", "cross_phase_corr")):
        return [out[k].cpu().numpy() for k in keys if k in out]

    def card_vs_cpu(label, got, want):
        """scattering max-abs over max 2e-5; phase rel-L2 1e-4; cross
        rel-L2 5e-2 (non-integer powers: chaotic in fp32)."""
        for name, g, w, (fn, bar) in zip(
                ("scattering", "phase", "cross"), got, want,
                ((max_rel, SCAT_REL_TOL), (rel_l2, PHASE_L2_TOL),
                 (rel_l2, CROSS_L2_TOL))):
            check(f"{label} {name} card vs CPU", fn(g, w), bar)

    # (a) order-2 scattering: the torch reference's golden, then the
    # production geometry against the port's CPU run
    for name in ("small_o2_phase", "small_o2_cross"):
        g = golden(name)
        sc = Scattering1D(int(g["J"]), int(g["Q"]), int(g["T"]), int(g["N"]),
                          max_order=2, device=device)
        x = g["x"][:, 0] if g["x"].ndim == 3 else g["x"]
        got = sc(torch.as_tensor(x, device=device)).cpu().numpy()
        check(f"order-2 scattering vs golden {name}, max-abs/max",
              max_rel(got, g["scattering"]), SCAT_REL_TOL)
    fhr, up = synthetic_fhr_up(N, np.random.default_rng(11), 8)
    o2 = [Scattering1D(11, 4, 16, N, max_order=2, device=d)
          for d in (device, cpu)]
    fhr_dev = torch.as_tensor(fhr, device=device)
    got = o2[0](fhr_dev)
    want = o2[1](torch.as_tensor(fhr)).numpy()
    check(f"order-2 scattering J=11 Q=4 T=16 B=8 ({o2[0].output_channels} "
          f"channels) card vs CPU, max-abs/max",
          max_rel(got.cpu().numpy(), want), SCAT_REL_TOL)
    report["order2_ms_b8"] = cuda_time_ms(lambda: o2[0](fhr_dev))

    # (b) the exact frontend on the reference's production fixtures
    exact = PhaseScattering1D(11, 4, 16, N, device=device)
    for name, kw, key in (
            ("prod_phase", dict(compute_phase=True), "phase_corr"),
            ("prod_cross", dict(compute_phase=False, compute_cross_phase=True),
             "cross_phase_corr")):
        g = golden(name)
        out = exact(torch.as_tensor(g["x"], device=device), **kw)
        check(f"exact all {out[key].shape[1]} pairs vs golden {name}, "
              f"max-abs/max", max_rel(out[key].cpu().numpy(), g[key]),
              GOLDEN_TOL[name])
    sel = exact.optimal_fhr_selection()
    p_idx = sel["phase_selection"]["selected_indices"]
    c_idx = sel["cross_selection"]["selected_indices"]
    x64 = golden("prod_cross")["x"].astype(np.float64)
    xt = torch.as_tensor(x64.astype(np.float32), device=device)
    out = exact.analyze(xt[:, 0], xt[:, 1])
    report["oracle_phase"] = rel_l2(out["phase_corr"].cpu().numpy(),
                                    fp64_phase_oracle(exact, x64, p_idx,
                                                      False))
    report["oracle_cross"] = rel_l2(out["cross_phase_corr"].cpu().numpy(),
                                    fp64_phase_oracle(exact, x64, c_idx,
                                                      True))
    check(f"exact {len(p_idx)} phase pairs vs float64 oracle, rel-L2",
          report["oracle_phase"], ORACLE_PHASE_TOL)
    check(f"exact {len(c_idx)} cross pairs vs float64 oracle, rel-L2 (the "
          f"torch reference's own distance is 3.3e-2)",
          report["oracle_cross"], ORACLE_CROSS_TOL)

    exact_cpu = PhaseScattering1D(11, 4, 16, N)
    fhr_t, up_t = (torch.as_tensor(a, device=device) for a in (fhr, up))
    card_vs_cpu("exact analyze B=8", families(exact.analyze(fhr_t, up_t)),
                families(exact_cpu.analyze(torch.as_tensor(fhr),
                                           torch.as_tensor(up))))
    # the dense decimation GEMM must run in true fp32 (TF32 off); show what
    # TF32 would cost against a float64 product
    gen = torch.Generator(device=device).manual_seed(3)
    cr, ci = (torch.randn((8, 174, N), generator=gen, device=device)
              for _ in range(2))
    lt = exact.phi_lt_src()
    ref = (cr.double().cpu().numpy() @ lt.real
           - ci.double().cpu().numpy() @ lt.imag)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    errs = {}
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            errs[flag] = max_rel(exact._phi_decimate(cr, ci).cpu().numpy(),
                                 ref)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"frontend: decimation GEMM (8x174x{N} -> 360) vs float64, "
        f"max-abs/max: TF32 off {errs[False]!r}, TF32 on {errs[True]!r}")
    check("decimation GEMM in fp32 vs float64, max-abs/max", errs[False],
          1e-5)
    reduced = PhaseScattering1D(11, 4, 16, N, max_order=1, reduced_rate=True,
                                device=device)
    reduced.plan(p_idx, c_idx)
    for b in (8, 32):
        xb = torch.randn((2, b, N), generator=gen, device=device)
        for label, sc in (("exact", exact), ("reduced", reduced)):
            report[f"{label}_analyze_ms_b{b}"] = cuda_time_ms(
                lambda: sc.analyze(xb[0], xb[1]))
    log(f"frontend: analyze ms on {card()} (CUDA events, median of "
        f"{TIMED_RUNS}): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                       report.items() if "analyze" in k)
        + f"; order 2 B=8 {report['order2_ms_b8']:.3f}")

    # (c) the dataset ETL at production width: build-data's recipe for the
    # 300-step parity run (16 records x 8 windows, seed 0), exact fp32 (the
    # default) and reduced rate with bf16 products, collected through
    # `write` (this machine has no h5py) into a packed store
    recipe = dict(n_records=ETL_RECORDS, windows_per_record=ETL_WINDOWS,
                  len_signal=N, seed=0)
    modes = {"exact": {}, "reduced_bf16": dict(
        max_order=1, reduced_rate=True, correlation_dtype=torch.bfloat16)}
    coeff_keys = ("fhr_st", "fhr_ph", "fhr_up_ph")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_scratch")
    os.makedirs(root, exist_ok=True)
    for mode, kw in modes.items():
        on_cpu, on_card = [], []
        want_res = build_dataset(
            None, **recipe, write=on_cpu.append,
            transform=PhaseScattering1D(11, 4, 16, N, **kw))
        sc = PhaseScattering1D(11, 4, 16, N, **kw, device=device)
        build_dataset(None, **dict(recipe, n_records=1), transform=sc,
                      write=lambda b: None)          # plans, first launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = build_dataset(None, **recipe, transform=sc, write=on_card.append)
        dt = time.perf_counter() - t0
        report[f"etl_{mode}_windows_per_s"] = recipe["n_records"] * recipe[
            "windows_per_record"] / dt
        log(f"etl {mode}: {res} in {dt:.3f} s, "
            f"{report[f'etl_{mode}_windows_per_s']:.1f} windows/s on "
            f"{card()} (CPU run: {want_res})")
        if res != want_res:
            failed.append(f"etl {mode} kept/skipped {res}, CPU {want_res}")
        got, want = (
            {k: np.concatenate([np.asarray(b[k]) for b in batches])
             for k in on_cpu[0]} for batches in (on_card, on_cpu))
        raw_equal = all(np.array_equal(got[k], want[k]) for k in want
                        if k not in coeff_keys)
        log(f"etl {mode}: raw fields, weights, epochs, labels and guids "
            f"bit-equal to the CPU's: {raw_equal}")
        if not raw_equal:
            failed.append(f"etl {mode}: raw fields differ from the CPU's")
        first = slice(0, ETL_WINDOWS)
        card_vs_cpu(f"etl {mode} record 0",
                    [got[k][first] for k in coeff_keys],
                    [want[k][first] for k in coeff_keys])
        calc = DatasetStatsCalculator(trim_minutes=2.0)
        for k in ("fhr", "up") + coeff_keys:
            calc.update(k, got[k])
        stats = calc.finalize()
        fields = ("fhr", "target", "weight") + coeff_keys
        with tempfile.TemporaryDirectory(dir=root) as tmp:
            store = PackedWindowStore.build(
                _Windows({k: got[k] for k in fields}), tmp)
            back = store.read_batch(range(4))
            same = all(np.array_equal(back[k], got[k][:4]) for k in fields)
            n_store = len(store)
        finite = all(np.isfinite(got[k]).all() for k in coeff_keys) and all(
            np.isfinite(st.mean).all() and np.isfinite(st.variance).all()
            for st in stats.values())
        log(f"etl {mode}: packed {n_store} windows, a batch read back equal: "
            f"{same}; statistics finite: {finite} (fhr_st channel 1 mean "
            f"{float(stats['fhr_st'].mean[1])!r})")
        if not (same and finite and n_store == res["kept"]):
            failed.append(f"etl {mode}: store of {n_store}, read back "
                          f"{same}, finite {finite}")

    # long records: windowed with overlap, per-record isolation
    records = list(synthetic_records(2, 3 * N, seed=0))
    res = [build_dataset_from_records(None, records, transform=t,
                                      write=lambda b: None)
           for t in (PhaseScattering1D(11, 4, 16, N, device=device),
                     exact_cpu)]
    log(f"etl records (2 x {3 * N} samples): card {res[0]}, CPU {res[1]}")
    if res[0]["errors"] or res[0] != res[1]:
        failed.append(f"etl records: card {res[0]}, CPU {res[1]}")
    log(f"frontend/ETL numbers: {json.dumps(report)}")
    if failed:
        raise AssertionError("frontend/ETL checks failed:\n"
                             + "\n".join(failed))
    return report


def main(argv) -> int:
    kernels_only = argv == ["--kernels"]
    if argv and not kernels_only:
        print("usage: chip_smoke.py [--kernels]", file=sys.stderr)
        return 2
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
    sources = ("wavefront_fwd.cu", "wavefront_bwd.cu")
    t0 = time.perf_counter()
    build.load_all(sources)
    log(f"built {', '.join(sources)} in parallel in "
        f"{time.perf_counter() - t0:.2f} s")
    for src in sources:   # per instantiation: registers, spills
        for line in build.build_logs.get(src, "").splitlines():
            if "Used" in line or "spill" in line:
                log(f"{src}: {line.strip()}")
    if kernels_only:          # phase 3 alone, also on an older checkout
        check_kernels(device)
        return 0
    check_residency(device)

    kernels = check_kernels(device)
    launches = serve(device)
    (res_launches, bwd_launches), fp32_times = train(device)
    bf16 = {"bf16_forward": bf16_forward(device),   # per phase
            "bf16_train": train_bf16(device, fp32_times),
            "fit": fit_phase(device)}
    frontend_etl_phase(device)

    case = ((4, 4), 32, torch.float32)
    entries = (("wavefront_fwd", "wavefront_fwd.cu", 80, launches, "fwd",
                "wavefront_fwd_bf16"),
               ("wavefront_fwd_residuals", "wavefront_fwd.cu", 80,
                res_launches, "fwd_res", "wavefront_fwd_res_bf16"),
               ("wavefront_bwd", "wavefront_bwd.cu", 187, bwd_launches, "bwd",
                "wavefront_bwd_bf16"))
    # each kernel's numbers at the main path's training batch (B=32, fp32)
    print(card())
    rows = []
    for name, src, line, n, key, bf16_entry in entries:
        err, ms, plain_ms, library_ms, (bound_ms, bound_by) = kernels[
            (key,) + case]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"vae_teb_tpu_torch/kernels/{src}",
            "replaces": f"vae_teb_tpu/models/wavefront_pallas.py:{line}",
            "launches": n, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "bf16_launches": {phase: counts.get(bf16_entry, 0)
                              for phase, counts in bf16.items()}})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
