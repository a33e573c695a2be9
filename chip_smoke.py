#!/usr/bin/env python3
"""Drive the PyTorch port's serving path, training step, training entry
point, exact frontend, dataset ETL, evaluation, streaming, the forecast,
predict-st and classifier families, data- and tensor-parallel training,
captured train steps, and LSTM widths that take the kernels zero-padded,
in depth groups or with their weights streamed, on an NVIDIA GPU.

    python3 chip_smoke.py             # from the repository root, one CUDA device
    python3 chip_smoke.py --kernels   # phases 1-3 only, printing no result
    python3 chip_smoke.py --serve     # phases 1, 2 and 4, printing no result
    python3 chip_smoke.py --grid      # phases 1, 2 and 12 (a), printing no result
    python3 chip_smoke.py --parallel  # phases 1, 2 and 13, printing no result
    python3 chip_smoke.py --capture   # phases 1, 2 and 14, printing no result
    python3 chip_smoke.py --coverage  # phases 1, 2 and 15, printing no result
    python3 chip_smoke.py --upsample  # phases 1, 2 and 16, printing no result
    python3 chip_smoke.py --layer-norm  # phases 1, 2 and 17, printing no result
    python3 chip_smoke.py --layer-norm-main  # phase 17 (c), its last line JSON

Run with --kernels, --serve or --grid from a copy placed at the root of
another checkout, it times that checkout's kernels or serving path (the
wrappers' and the server's signatures are unchanged since the first
kernels, the grid kernels' since they came), so two versions compare on
one card.

Phases, each of which raises on failure (exit code 1):
  1. device: CUDA must be present (exit 2 otherwise, before any result);
  2. build the wavefront kernels (vae_teb_tpu_torch/kernels/wavefront_fwd.cu,
     wavefront_bwd.cu, wavefront_grid_fwd.cu and wavefront_grid_bwd.cu)
     the upsample kernels (upsample.cu) and the LayerNorm kernels
     (layer_norm.cu), one nvcc each, in parallel,
     for sm_90a; print
     each instantiation's ptxas registers and spills, and the launch plan
     of each main-path batch (rows per cluster, clusters of 8 CTAs, shared
     memory) with the clusters the card holds at once, and the grid plan
     of each phase-12 shape at B=32 (columns a CTA, CTAs a cluster, ring
     buffers, shared memory);
  3. kernels against their plain PyTorch versions on the card, at the
     serving/training shape (two 4-layer H=64 streams, S=300, K=303) at
     B = 32 (fp32 and bf16 storage), 128 and 1, and a 4+2-layer shape:
     the serving forward and the residual forward (max-abs <= 1e-5 fp32,
     1.6e-2 bf16; the stored gates per element to that times max(1,
     |gate|)), the reverse wavefront (max-abs <= 1e-5 fp32, 3e-2 bf16, of
     max|plain| on each output). At 2x4 layers, B = 32 and 128 fp32 and
     B = 32 bf16, also CUDA-event times (median of 15 runs; plain 5), the
     bound (fp32 operations on the non-zero weight blocks, over the S
     steps each unit runs, over 67 TFLOP/s fp32 (the cluster kernels'
     CUDA cores; the grid kernels' 3xTF32: three products at 495 TFLOP/s)
     or 989 TFLOP/s for bf16 storage, or bytes over 3.35 TB/s) and the
     yardstick: cuDNN's LSTM (`torch.nn.LSTM`, one per stream) computing
     the same function, held
     to the kernel's outputs at 1e-4 of max (bf16 storage: 1.6e-2) and
     timed forward and backward-data; then the serving forward at B=244
     (one shift program of phase 10: 25 clusters, more than the card
     holds at once, so it runs in waves), fp32 and bf16, with its launch
     plan and waves, rows 0-149 and 150-243 held apart, times, bound and
     the cuDNN yardstick (fp32 and bf16); then the streaming encode's
     launches, one 4-layer stream (U=4: clusters of 4 CTAs, whose plan it
     prints) from a random non-zero h0/c0, at B = 1 and 32, S = 1 (K=4)
     and 300, fp32 and bf16, each held to the plain version at the bars
     above, with times, bound and (fp32) the cuDNN yardstick; and the host
     time of a call of the operator vae_teb_tpu_torch::wavefront_fwd
     against a direct launch;
  4. serve raw (B, 5760) FHR/UP windows at B = 1, 8 and 32 through the
     full-width fp32 model (seeded init) and the production reduced-rate
     frontend; check shapes, finiteness, that every forward launched the
     serving kernel, agreement with the plain recurrence on the card, and
     agreement with a CPU run on a B=1 window;
  5. train the full-width model (Trainer defaults: fp32, beta 1e-5, clip
     0.5, AdamW lr 1e-4): 10 steps at B=32 and 5 at B=128 on fixed batches
     of raw windows through the frontend on the card; check finite losses,
     a falling B=32 loss, one residual-forward and one backward launch per
     step; then, from the seeded weights, one B=8 step against the plain
     recurrence on the card and one B=2 step against the CPU on identical
     coefficients and noise (the gradient's worst leaf within
     FP32_NUDGE_RATIO times the CPU's own move when the coefficients move
     by half an fp32 ulp);
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
 10. evaluation (`cli test`'s device work; the card has no matplotlib, so
     ModelEvaluator is driven directly and no figure is written): 50
     windows of build-data's recipe through the exact frontend on the card,
     the trimmed and the raw readers' layouts, the full-width fp32 model;
     reconstruction_analysis and up_ablation at batch 4, analyze_sample at
     B=1, latent_interpolation with 8 steps, seqvae_mse_test, then TE vs UP
     shift (-60..0 s) and vs UP gain (5 gains) in chunks of 4 samples: 13
     programs of up to 244 rows and 13 of up to 20; checks shapes,
     finiteness, one serving-kernel launch per encode, shift 0 against gain
     1.0 and against up_ablation's TE (1e-3 per entry), a 244-row program
     against the plain recurrence on the card (1e-4 of max), and sample 0's
     rows against a CPU run (1e-2 per entry; gain 0 at 1e-4 of max); prints
     CUDA-event times, windows/s and peak memory;
 11. streaming and serving artifacts on the full-width fp32 model (seed 2,
     TF32 off) and x_ph of the production frontend: StreamingSession at
     B = 1 and 32 over chunks (1, 7, 30, 262) and over 60 chunks of 1,
     against the full-sequence source encode on the card (1e-5 of max),
     one serving-kernel launch per chunk, against the same session through
     the plain recurrence on the card (1e-5), a resume from a copied state bit
     for bit, B=1 against a CPU session (1e-4 of max); the bf16 policy's
     LSTM chained from its bf16 state bit for bit against one pass, and
     its session against its full encode (3e-2 of max), beside the full
     encode's own move when its rows are encoded one by one; per-chunk
     latency at chunk 1 and 30 (CUDA events) beside the full recompute of
     get_sequence_encoding; export_inference on the card with a symbolic
     batch traced at B=2, weights as argument and bundled, saved, loaded
     and run at B = 1, 8 and 32 against the live model (1e-6 of max, one
     launch per call), the artifacts' bytes, load time and B=32 latency
     against the live model; export_source_stream at B=32, chunk 1,
     chained 30 steps against the session (1e-6 of max);
 12. the shapes the cluster kernels refuse, on the grid kernels, and the
     model families that need them: (a) the grid kernels (serving,
     residual, reverse) against their plain versions at (U, H) = (3, 256)
     and (2, 256) (the decoders' LSTMs), (8, 128) and (10, 64), B=32,
     S=300, fp32 and bf16, at phase 3's bars, with their launch plans
     (columns a CTA, CTAs, CTAs a cluster, ring buffers), CUDA-event
     times, bounds and the cuDNN yardstick (held at 1e-4 of max in fp32);
     `--grid` runs this part alone; (b) full-width
     SeqVaeTebForecast(decoder_type="direct") on seeded raw windows
     through the production frontend: 4 train steps at B=32 (forward,
     compute_loss(beta=1e-5), backward, ClippedAdamW), each launching the
     encoders' cluster kernels and the decoder LSTM's grid kernels once
     each way, a B=8 step's gradients against the plain reverse wavefront
     behind the same forward (1e-4 per leaf), a B=2 step against the CPU
     (phase 5's bars), step times; (c) the conv-window decoder at B=8,
     forward and loss against the CPU; (d) full-width SeqVaeTebPredictSt
     (horizon 30): (b)'s step and checks, then prediction_accuracy_test
     (prediction_idx 30) on 8 windows; (e) full-width SeqVaeTebClassifier
     with ClassifierTrainer at B=32: transfer_params from the seeded
     SeqVaeTeb, 10 frozen steps on a separable labelling (loss falling,
     one serving launch and no backward launch a step, the frozen VAE's
     weights moving by optax's decay alone), predict, one joint step
     (freeze_vae=False, vae_loss_weight 0.1: one residual forward and one
     reverse launch), step times;
 13. data- and tensor-parallel training of the full-width fp32 model from
     the seeded weights (TF32 off) at a global B=64 on seeded windows
     through the production frontend, ranks spawned by
     torch.multiprocessing that load the kernels this process built: (a)
     two ranks sharing cuda:0 over gloo, data parallel, 3 steps, each rank
     launching wavefront_fwd_res_f32 and wavefront_bwd_f32 once a step at
     B=32, every step held to the plain Trainer from the run's full state
     before it (losses and statistics 1e-4; gradients, grad_norm and
     parameters FP32_NUDGE_RATIO times that plain step's own move under
     half-ulp nudges of the coefficients); (b) a one-rank NCCL world through the data-parallel
     path against the plain Trainer: the forward bit for bit, the rest no
     further apart than two plain runs, both step times; (c) two ranks as
     1 data x 2 model, the four head kernels sharded, 2 steps checked as
     (a), each rank's parameter and Adam moment bytes; (d) `cli train
     --multihost` as a one-rank torchrun world on NCCL for one epoch on a
     packed store; a checkpoint must exist. Step times of two ranks on one
     card are no measure of multi-card speed. A rank that fails or passes
     PARALLEL_TIMEOUT_S fails the phase;
 14. steps_per_execution: the train step captured as a CUDA graph and
     replayed (Trainer.train_multi_step) on the full-width fp32 model from
     the seeded weights: (a) at B=32, 8 eager steps five times from one
     state (E1-E5) and two groups of K=4 (C: the first eager, the second
     four replays); C bit for bit with E1 where every run is the same by
     construction (the count, the generator state, the step, the first
     step's losses), and each group of entries (each metric over the 8
     steps, parameters, statistics, each moment; the state's groups
     against their move from the start) within twice the largest
     relative distance between two eager runs, or 1e-5 (the backward is
     not deterministic on the card); then one replay from C's state
     against three eager steps from it, at the same bars, which must
     reject two controls (no step; bias corrections at the capture's
     count); the train-mode forward with its losses and the optimizer
     step, each captured alone and replayed from the eager run's state,
     bit for bit; (b) C launched
     wavefront_fwd_res_f32 and wavefront_bwd_f32 8 times each by the
     counters, a torch.profiler window over one replay shows each kernel
     once, and the host calls that start device work, a step, captured
     against eager; (c) ms a step, device busy time, idle share, device
     events, host launch calls and peak memory, eager against captured,
     at B = 32 and 128 in fp32 and in bf16 (bf16 moments); (d)
     `cli.run_training` on a packed store of 10 batches of 32 (device
     normalization, 2 epochs) with steps_per_execution 4 (groups 4, 4, 2
     an epoch) against three runs with 1: the history within twice the K=1
     runs' spread, windows/s of each epoch; (e) SeqVaeTeb(lstm_hidden_dim=128),
     whose LSTM takes the grid kernels' cooperative launch, at B=32: two
     groups of 2 against 4 eager steps five times, held as (a), 4
     launches of each grid kernel; (f) accumulate_grad_batches=2 with K=4
     as (a): a graph a micro-step, each replayed twice, the count and the
     micro-step exact, one replay of each micro-step from one state;
     `--capture` runs this phase alone;
 15. LSTM shapes the kernels take only zero-padded (H not a multiple of 8),
     in depth groups (stacks too wide for one launch) or with streamed
     weights (units too wide for a CTA's shared memory), through the
     model's own packing (`models.blocks.run_lstm_streams`): (a) two
     4-layer streams of H = 5, 60, 100, padded to 8, 64, 104 (cluster,
     cluster, grid kernels), K=303, B=32, fp32 and bf16: the three kernels
     against their plain versions at phase 3's bars, with times (this
     phase's: CUDA events, median of 5), bound (of the unpadded function)
     and cuDNN; (a, b) SeqVaeTeb at
     lstm_hidden_dim 5, 60, 100 and 512 (the last: two 4-layer streams of
     H=512 in depth groups, which the card's residency decides and the
     phase prints), fp32 and bf16, B=32, on coefficients of seeded raw
     windows: one serving forward and one train step, each launching one
     kernel a depth group each way, against the plain recurrence on the
     card in the same groups (serving at phase 4's and 6's bars, the
     gradients at phase 5's and 7's); at 512 also the plain recurrence
     chained against one group (what the hoisted projections move), the
     encoder LSTMs alone against cuDNN's torch.nn.LSTM(in, 512, 4) per
     stream (serving forward, forward and backward), and each group's
     kernels at its shape with times, bound and cuDNN; (c) at 512 fp32,
     a train step captured (steps_per_execution 2) and one replay from
     that run's state against three eager steps (phase 14's bar and
     controls), each replay launching one kernel a group each way; (d)
     units over a CTA's shared memory, on the streamed grid kernels: the
     three streamed entries against their plain versions at (depths, H)
     = (1, 1024), (1+1, 1024), (2+2, 1024: two feed blocks) fp32 and
     (1+1, 1536) bf16, B=32, K=303, at phase 3's bars, with times
     (median of 5), plain times, bound, cuDNN; for each, the plan's
     resident share, the chunks a CTA streams a step, the weight and row
     bytes a step reads from L2 with the rate achieved, and the L2 floor:
     the same launches timed from a build without the streamed products
     (-DWAVEFRONT_STREAM_NO_PRODUCT, libraries of their own, swapped in
     for the timing only); the plan the card chose at (1+1, 1024) fp32
     and (1+1, 1536) bf16 against no resident share and, where it took
     another cluster size, clusters of 2 (forward and reverse times, each
     at phase 3's bars); then SeqVaeTeb(lstm_hidden_dim=1024)
     fp32 and 1536 bf16 as (a, b) (serving forward and train step against
     the plain recurrence in the same groups, one streamed launch a group
     each way, every launch streamed), the encoder LSTMs alone against
     cuDNN, and at 1024 fp32 (c)'s captured step, one replay against
     three eager steps; `--coverage` runs this phase alone;
 16. the decoder's upsample kernels (kernels/upsample.cu): (a) at its
     four shapes at B=128 in its layout, fp32 and bf16, the forward equal
     to F.interpolate (fp32) or the plain blends (bf16) bit for bit, the
     gather equal to the plain gather and to itself across runs, and
     within 1e-6 (fp32) or 8e-3 (bf16) of max|dx| of float64 autograd;
     times (a run of 10 launches over 10, median of 15) of the kernels,
     the plain versions and PyTorch's upsample_linear1d forward and
     backward, beside the bytes bound; (b)
     SeqVaeTeb at B=128: 4 launches each way in an eager train step and in
     a replay of the captured step (4 forward in an eval forward), each
     upsample kernel's device time in place from the profiler, and no
     upsample_linear1d kernel; `--upsample` runs this phase alone;
 17. the LayerNorm kernels (kernels/layer_norm.cu): (a) at the main path's
     shapes, (38400, 16 / 32 / 64 / 130 / 458) and (128, 4800), the
     forward and backward against the float64 plain version (within 4x
     PyTorch's own float32 LayerNorm's error, or 2e-6 of max), the
     backward equal to itself across runs; device times (10 calls in a
     CUDA graph, its replay over 10, median of 15) of the kernels, the
     plain versions and PyTorch's LayerNorm forward and backward, beside
     the bytes bound; (b) host us a call (200 calls unsynchronized, the
     four kinds in turns, median of 61 rounds) of the eval path, a
     blocks.LayerNorm module and the bare wrapper, against an
     nn.LayerNorm module's and F.layer_norm's, at (38400, 32) and (1200,
     64), failing where ours is slower in three rounds of four or more;
     (c) in a process of its own (`--layer-norm-main`), SeqVaeTeb at
     B=128: 115 launches each way in an eager train step and in a replay
     of the captured step (115 forward in an eval forward), the kernels'
     device time in place from the profiler, and no PyTorch LayerNorm
     kernel; `--layer-norm` runs this phase alone;
 18. print the card's nvidia-smi name and power limit, one JSON line for
     the kernels (with their bf16 launches in each of phases 6, 7 and 8,
     counted from 0 at that phase's start, the serving forward's launches
     in phase 10, in phase 11 the sessions' and the loaded programs', and
     phase 12's model runs', and phase 13's per world and rank
     (`parallel_launches`), and phase 14's launches by graph replays, per
     storage type (`captured_launches`), and phase 15's model runs', per
     storage type (`coverage_launches`); the grid kernels' rows at (3,
     256), B=32, fp32, with their errors, times, cuDNN times and bounds at
     every phase-12 shape and storage type, `by_shape`; the streamed
     entries' rows at (1+1, 1024), B=32, fp32, launched by phase 15 (d)'s
     model runs and its captured step's replay, with every (d) kernel
     shape's numbers, `by_shape`; the upsample entries' rows with phase
     16's numbers, `by_shape`, and launches; the LayerNorm entries' rows
     with phase 17's), and last {"ok": true, "device": {...}}.
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
# published peaks of one H100 SXM: fp32 outside the tensor cores, TF32 and
# bf16 dense on the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
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
KINK_REL_TOL = 1e-1   # worst leaf, where no sensitivity run sets the bar
KINK_L2_TOL = 2e-2    # model-wide
# fp32 runs whose forwards differ by rounding (phase 5's card against the
# CPU, phase 13's meshes against one process): the gradient's worst leaf
# (and in phase 13 its rel-L2 and the updated parameters) within this many
# times the reference's own move when its coefficients move by half an
# fp32 ulp (the larger of NUDGE_DRAWS draws). The nudge perturbs the input
# once; the compared runs round differently in every layer (summation
# orders, the mesh's BatchNorm reduction): measured ratios 0.46-1.6
# (PERF.md, PR 10); a fault (a wrong row, a missing average) moves these
# by O(1).
FP32_NUDGE_RATIO = 3.0
NUDGE_DRAWS = 2
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
# Phase 10: the 50-sample battery of `cli test` (its default --num-samples),
# the suite's batch of 4 and recompute chunk of 4 samples x 61 shifts
EVAL_SAMPLES, EVAL_BATCH, EVAL_CHUNK = 50, 4, 4
WAVE_BATCH = 4 * 61   # one shift program's rows: the first multi-wave launch
# TE entries (mean over steps and latent dims) recomputed through the exact
# frontend in two runs of different batch size on the card, and card
# against the CPU, relative per entry: the cross family's fp32 phase
# acceleration is chaotic, so rounding that differs between runs can flip
# a coefficient sample at the branch cut, which the mean over 300 steps
# dilutes; card and CPU FFTs round further apart (PERF.md gives the
# measured values). A misplaced row moves an entry by ~1e-1.
EVAL_SAME_CARD_TOL, EVAL_CPU_TOL = 1e-3, 1e-2
# Phase 3's single-stream cases: (batch, S) of the streaming encode's
# launches (S=1 is K=4, a chunk of one step)
STREAM_KERNEL_CASES = ((1, 1), (32, 1), (1, 300), (32, 300))
OP_CALLS = 200        # calls timed for the operator's host overhead
# Phase 11 (PERF.md gives the measured values). Chained chunks against the
# full encode: the layer-0 projection runs over other row counts, so cuBLAS
# may sum in another order: the JAX package's streaming bar
# (tests/test_models.py). A loaded program against the live model runs the
# same kernels on the same inputs.
STREAM_CHUNKS = (1, 7, 30, 262)
STREAM_STEPS = 60
STREAM_TOL, STREAM_CPU_TOL, EXPORT_TOL = 1e-5, 1e-4, 1e-6
# The bf16 session against the bf16 full encode, of max: the bf16 MLP's
# GEMMs over other row counts round a product a ulp apart, which the
# recurrence carries on (measured 1.85e-2; the full encode moves 2.16e-2
# when its rows are encoded one by one). A wrong carried state is O(1).
BF16_STREAM_TOL = 3e-2
ARTIFACT_BATCHES = (1, 8, 32)
ARTIFACT_STEPS = 30
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


def bound(kind, B, K, S, U, H, n_feed, itemsize, tensor_fp32=False):
    """(bound_ms, bound_by): the least time the card could take for one
    call, the larger of the operations the non-zero weight blocks need
    (2 * H * 4H per block, per row, per step that its unit runs: S of the K
    wavefront steps) at the rate of the route the kernel's products take
    (fp32 storage: 67 TFLOP/s on the CUDA cores, or with `tensor_fp32`
    three TF32 products each, 3xTF32, at 495 TFLOP/s on the tensor cores;
    bf16: 989 TFLOP/s, the tensor cores) and the bytes of every input read
    once and every output written once over the memory rate."""
    UH, G = U * H, 4 * U * H
    blocks = U + n_feed
    flops = 2 * H * 4 * H * blocks * B * S
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
    if itemsize == 2:
        rate = PEAK_BF16_FLOPS
    else:
        rate = PEAK_TF32_FLOPS / 3 if tensor_fp32 else PEAK_FP32_FLOPS
    ops_ms = flops / rate * 1e3
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


def cudnn_times(streams, gen, runs=TIMED_RUNS):
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
    return cuda_time_ms(fwd, runs), cuda_time_ms(bwd, runs)


def check_residency(device):
    """The launch plans of the main path's shapes as the wrappers make
    them: rows per cluster chosen so that every cluster of U=8 CTAs is
    resident at once, by the card's cudaOccupancyMaxActiveClusters; and the
    grid plans of phase 12's shapes at B=32."""
    from vae_teb_tpu_torch.kernels.wavefront import (_card_grid_resident,
                                                     _card_resident,
                                                     _launch_plan)
    for depths, H in GRID_KERNEL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            plan = _launch_plan(32, sum(depths), H, dtype,
                                grid_resident=_card_grid_resident(device,
                                                                  dtype))
            log(f"grid {'x'.join(map(str, depths))} layers H={H} B=32 "
                f"{str(dtype)[6:]}: {plan}")
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


def pad_units(args, H, Hp):
    """Wavefront operands packed at width H (`recurrence_inputs`) as
    `run_lstm_streams` packs them for H not a multiple of 8: each unit's
    blocks at [:H] of Hp columns, zeros in the rest."""
    W, b, xs, h0, c0, lvec = args
    U = lvec.numel()
    K, B = xs.shape[:2]
    Wp = W.new_zeros(U, Hp, 4, U, Hp)
    Wp[:, :H, :, :, :H] = W.view(U, H, 4, U, H)
    bp = b.new_zeros(4, U, Hp)
    bp[..., :H] = b.view(4, U, H)
    xp = xs.new_zeros(K, B, 4, U, Hp)
    xp[..., :H] = xs.view(K, B, 4, U, H)
    return (Wp.view(U * Hp, 4 * U * Hp), bp.view(-1), xp.view(K, B, -1),
            pad_state(h0, H, Hp), pad_state(c0, H, Hp), lvec)


def pad_state(x, H, Hp):
    """(..., U * H) states or cotangents at (..., U * Hp), zero padded."""
    return torch.nn.functional.pad(x.unflatten(-1, (-1, H)), (0, Hp - H)
                                   ).flatten(-2)


def unpad(x, H, Hp):
    """(..., n * Hp) packed columns back to each unit's first H."""
    return x.unflatten(-1, (-1, Hp))[..., :H].flatten(-2)


def check_kernels(device, S=300, H=64, cases=KERNEL_CASES,
                  library_bars=LIBRARY_REL_TOL, pad_to=None,
                  plain_runs=PLAIN_RUNS, runs=TIMED_RUNS):
    """The three kernels against their plain versions on the card, with
    times, bounds and the cuDNN yardstick (held to the kernel at
    `library_bars[dtype]`, reported only for a dtype it does not name);
    prints each case's launch plan; returns {(kind, depths, B, dtype):
    (err, ms, plain_ms, library_ms, (bound_ms, bound_by))}. With `pad_to`,
    the operands of width H run zero-padded to that width (`pad_units`),
    as the model runs an H that is not a multiple of 8: cuDNN and the
    bound take the unpadded function. `plain_runs` 0 times no plain
    version (plain_ms None); `runs` are the kernels' and cuDNN's timed
    runs."""
    from vae_teb_tpu_torch.kernels import (wavefront_bwd, wavefront_bwd_plain,
                                           wavefront_fwd, wavefront_fwd_plain)
    from vae_teb_tpu_torch.kernels.wavefront import _check, _launch_plan
    gen = torch.Generator().manual_seed(4)
    results, failed = {}, []
    for depths, b, dtype, timed in cases:
        fp32 = dtype == torch.float32
        tol = FP32_TOL if fp32 else BF16_TOL
        btol = BWD_FP32_TOL if fp32 else BWD_BF16_TOL
        name = str(dtype)[6:]
        label = (f"{'x'.join(map(str, depths))} layers H={H} B={b} S={S} "
                 f"{name}")
        raw = recurrence_inputs(gen, b, S, H, depths, dtype, device)
        Hp = pad_to or H
        args = pad_units(raw, H, Hp) if pad_to else raw
        if pad_to:
            label += f" padded to {Hp}"
        W, _, xs, h0, c0, lvec = args
        K, U = xs.shape[0], lvec.numel()
        n_feed = int((lvec > 0).sum())
        log(f"{label}: launch plan {_check('plan', args[:5], lvec, xs)}")
        time_pair = (lambda f, g: (cuda_time_ms(f, runs), cuda_time_ms(
            g, plain_runs) if plain_runs else None)
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
        bargs = (W, gates_seq, c_seq, c_prev) + tuple(
            pad_state(x, H, Hp) for x in (rnd(K, b, UH), rnd(b, UH),
                                          rnd(b, UH))) + (lvec,)
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
            streams = cudnn_streams(raw, depths, S)
            lib_err = cudnn_check(streams, depths, *(
                unpad(x, H, Hp) for x in fwd_out), S)
            lib_tol = library_bars.get(dtype)
            log(f"cuDNN LSTM yardstick {label}: ys, h_n, c_n against the "
                f"kernel max-abs/max {lib_err!r} (tol {lib_tol})")
            if lib_tol is not None and not lib_err <= lib_tol:
                failed.append(f"cuDNN yardstick {label}: {lib_err} > "
                              f"{lib_tol}")
            lib_fwd, lib_bwd = cudnn_times(streams, gen, runs)
            lib = {"fwd": lib_fwd, "fwd_res": lib_fwd, "bwd": lib_bwd}
        except RuntimeError as e:     # a type cuDNN's LSTM does not take
            log(f"cuDNN LSTM yardstick {label}: not available ({e})")
        # the grid kernels, resident or streamed, run fp32 products on the
        # tensor cores (3xTF32), the cluster kernels on the CUDA cores
        grid = _launch_plan(b, U, Hp, dtype).kind != "cluster"
        for kind in ("fwd", "fwd_res", "bwd"):
            bnd = bound(kind, b, K, S, U, H, n_feed, xs.element_size(), grid)
            results[(kind, depths, b, dtype)] += [lib[kind], bnd]
            _, ms, _ = results[(kind, depths, b, dtype)][:3]
            log(f"{kind} {label}: kernel {ms!r} ms, cuDNN {lib[kind]!r} ms, "
                f"bound {bnd[0]!r} ms ({bnd[1]}), {bnd[0] / ms:.4%} of the "
                f"bound")
    if failed:
        raise AssertionError("kernels disagree with their plain versions "
                             "or the yardstick: " + "; ".join(failed))
    return results


def check_waves(device, S=300, H=64):
    """Phase 3's multi-wave case: the serving forward at B = 244 (one shift
    program of phase 10) in fp32 and bf16 storage, kernel against plain at
    phase 3's bars, with its launch plan (rows per cluster, clusters, the
    clusters the card holds at once, waves), CUDA-event times, the bound,
    and cuDNN's LSTM forward as the yardstick."""
    from vae_teb_tpu_torch.kernels import wavefront_fwd, wavefront_fwd_plain
    from vae_teb_tpu_torch.kernels.wavefront import (_card_resident,
                                                     _launch_plan)
    gen = torch.Generator().manual_seed(6)
    depths, b = (4, 4), WAVE_BATCH
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        args = recurrence_inputs(gen, b, S, H, depths, dtype, device)
        K, U = args[2].shape[0], args[5].numel()
        held_fn = _card_resident(device, dtype, U, H)
        plan = _launch_plan(b, U, H, dtype, held_fn)
        held = held_fn(plan.rows, plan.fwd_smem, plan.bwd_smem)
        waves = -(-plan.clusters // held)
        got = wavefront_fwd(*args, S)
        want = wavefront_fwd_plain(*args, S)
        torch.cuda.synchronize()
        errs = [max((g[..., rows, :].float() - w[..., rows, :].float()
                     ).abs().max().item() for g, w in zip(got, want))
                for rows in (slice(0, 150), slice(150, b))]
        ms = cuda_time_ms(lambda: wavefront_fwd(*args, S))
        plain_ms = cuda_time_ms(lambda: wavefront_fwd_plain(*args, S),
                                PLAIN_RUNS)
        bnd = bound("fwd", b, K, S, U, H, int((args[5] > 0).sum()),
                    args[2].element_size())
        name = str(dtype)[6:]
        streams = cudnn_streams(args, depths, S)
        lib_err = cudnn_check(streams, depths, *got, S)
        if not lib_err <= LIBRARY_REL_TOL[dtype]:
            failed.append(f"cuDNN yardstick B={b} {name}: {lib_err}")
        lib_ms = cudnn_times(streams, gen)[0]
        log(f"serving forward 4x4 layers B={b} S={S} {name}: plan "
            f"M={plan.rows} rows per cluster, {plan.clusters} clusters of {U} CTAs, the "
            f"card holds {held} at once: {waves} waves; max_abs_err rows "
            f"0-149 {errs[0]!r}, rows 150-{b - 1} {errs[1]!r} (tol {tol}); "
            f"kernel {ms!r} ms, plain {plain_ms!r} ms, cuDNN {lib_ms!r} ms "
            f"(max-abs/max {lib_err!r}, tol {LIBRARY_REL_TOL[dtype]}), "
            f"bound {bnd[0]!r} ms ({bnd[1]}), {bnd[0] / ms:.4%} of the bound")
        if not max(errs) <= tol:
            failed.append(f"serving forward B={b} {name}: {max(errs)} > {tol}")
    if failed:
        raise AssertionError("multi-wave forward: " + "; ".join(failed))


def check_single_stream(device, H=64):
    """Phase 3's streaming cases: the serving forward on one 4-layer stream
    (U=4, clusters of 4 CTAs) from a random non-zero h0/c0, as a chunk of
    the streaming source encode launches it, at every (B, S) of
    STREAM_KERNEL_CASES in fp32 and bf16 storage: kernel against plain at
    phase 3's bars, CUDA-event times, the bound (4 recurrent and 3 feed
    blocks) and cuDNN's 4-layer LSTM from the same state (held at
    LIBRARY_REL_TOL; in bf16 storage its time is no yardstick: PyTorch
    re-packs the bf16 LSTM's weights on every call); the launch plan of
    each batch. Then the host time of one call of the
    operator against a direct launch (B=1, K=4). Returns {(B, S, dtype):
    (err, ms, plain_ms, library_ms, (bound_ms, bound_by))}."""
    from vae_teb_tpu_torch.kernels import wavefront_fwd, wavefront_fwd_plain
    from vae_teb_tpu_torch.kernels.wavefront import (_card_resident, _fwd_cuda,
                                                     _launch_plan,
                                                     wavefront_fwd_op)
    gen = torch.Generator().manual_seed(7)
    depths = (4,)
    results, failed = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        held = _card_resident(device, dtype, 4, H)
        for b in sorted({b for b, _ in STREAM_KERNEL_CASES}):
            plan = _launch_plan(b, 4, H, dtype, held)
            slots = held(plan.rows, plan.fwd_smem, plan.bwd_smem)
            log(f"single stream B={b} {name}: {plan.clusters} clusters of 4 "
                f"CTAs x {plan.rows} rows, shared memory {plan.fwd_smem} B; "
                f"the card holds {slots} such clusters at once")
        for b, S in STREAM_KERNEL_CASES:
            args = recurrence_inputs(gen, b, S, H, depths, dtype, device)
            K = args[2].shape[0]
            got = wavefront_fwd(*args, S)
            want = wavefront_fwd_plain(*args, S)
            torch.cuda.synchronize()
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
            scale = max(w.float().abs().max().item() for w in want)
            ms = cuda_time_ms(lambda: wavefront_fwd(*args, S))
            plain_ms = cuda_time_ms(lambda: wavefront_fwd_plain(*args, S),
                                    PLAIN_RUNS)
            bnd = bound("fwd", b, K, S, 4, H, 3, args[2].element_size())
            streams = cudnn_streams(args, depths, S)
            lib_err = cudnn_check(streams, depths, *got, S)
            if not lib_err <= LIBRARY_REL_TOL[dtype]:
                failed.append(f"cuDNN yardstick B={b} S={S} {name}: "
                              f"{lib_err}")
            lib_ms = cudnn_times(streams, gen)[0]
            label = f"single stream (4,) B={b} S={S} K={K} {name}"
            log(f"serving forward {label}: max_abs_err={err!r} (tol {tol}, "
                f"max|plain| {scale!r}) kernel {ms!r} ms, plain {plain_ms!r} "
                f"ms, cuDNN {lib_ms!r} ms (max-abs/max {lib_err!r}), bound "
                f"{bnd[0]!r} ms ({bnd[1]}), {bnd[0] / ms:.4%} of the bound")
            if not err <= tol:
                failed.append(f"serving forward {label}: {err} > {tol}")
            results[(b, S, dtype)] = (err, ms, plain_ms, lib_ms, bnd)
    # the operator's host overhead: enqueue time of a call, host clock
    args = recurrence_inputs(gen, 1, 1, H, depths, torch.float32, device)
    host = {}
    for label, fn in (("operator", lambda: wavefront_fwd_op(*args, 1)),
                      ("direct launch", lambda: _fwd_cuda(*args, 1, False))):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(OP_CALLS):
            fn()
        host[label] = (time.perf_counter() - t) / OP_CALLS * 1e6
        torch.cuda.synchronize()
    log(f"host time a call (B=1, K=4, {OP_CALLS} calls): operator "
        f"{host['operator']!r} us, direct launch {host['direct launch']!r} us"
        f", overhead {host['operator'] - host['direct launch']!r} us")
    if failed:
        raise AssertionError("single-stream forward: " + "; ".join(failed))
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
    # the step comparisons below start from the seeded weights: the card's
    # training runs reduce in an order that varies between runs, so the
    # state they reach varies, and with it which ReLU inputs sit within
    # rounding of a kink (PERF.md, section 6)
    seeded = copy.deepcopy(model)
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

    # one B=8 step from the seeded weights and the same noise: the kernels
    # against (a) the plain reverse wavefront behind the kernel forward, so
    # both runs share a bit-identical forward, and (b) the plain recurrence
    # for both directions (autograd differentiates the plain loop), whose
    # forward differs by rounding
    fhr, up, y_raw = batch_of(8)
    batch = fields(frontend(fhr, up), y_raw)
    eps = torch.randn((8,) + latent, generator=gen, device=device)
    wavefront_module = sys.modules["vae_teb_tpu_torch.kernels.wavefront"]
    grads = {}
    for name in ("kernels", "plain backward", "plain recurrence"):
        m = copy.deepcopy(seeded)
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

    # one B=2 step on identical coefficients and noise on the CPU, and the
    # CPU's step on coefficients nudged by half an fp32 ulp (NUDGE_DRAWS
    # draws): the gradient's own sensitivity sets the leaf bar
    fhr, up, y_raw = batch_of(2)
    coeffs = frontend(fhr, up)
    batch = fields(coeffs, y_raw)
    eps = torch.randn((2,) + latent, generator=gen, device=device)
    gpu_model, cpu_model = copy.deepcopy(seeded), copy.deepcopy(seeded).cpu()
    before = [p.detach().clone() for p in cpu_model.parameters()]
    m_gpu = Trainer(gpu_model, cfg, device).train_step(batch, beta, eps=eps)
    m_cpu = Trainer(cpu_model, cfg, "cpu").train_step(
        {k: v.cpu() for k, v in batch.items()}, beta, eps=eps.cpu())
    cpu_grads = {k: p.grad for k, p in cpu_model.named_parameters()}
    nudges = []
    for _ in range(NUDGE_DRAWS):
        m = copy.deepcopy(seeded).cpu()
        nudged = fields(nudge_bar(coeffs, gen), y_raw)
        Trainer(m, cfg, "cpu").train_step(
            {k: v.cpu() for k, v in nudged.items()}, beta, eps=eps.cpu())
        nudges.append(grad_report({k: p.grad for k, p in
                                   m.named_parameters()}, cpu_grads))
        del m
    nudge, nudge_leaf, nudge_l2 = max(nudges)
    rel = {k: abs(m_gpu[k].item() / m_cpu[k].item() - 1) for k in m_cpu}
    norm_err = rel.pop("grad_norm")   # a model-wide L2: moves with kinks
    loss_err = max(rel.values())
    check("card vs CPU losses", loss_err, METRIC_REL_TOL)
    check("card vs CPU grad_norm", norm_err, KINK_L2_TOL)
    worst, leaf, l2 = grad_report(
        {k: p.grad.cpu() for k, p in gpu_model.named_parameters()},
        cpu_grads)
    check(f"card vs CPU gradients: worst leaf {leaf}", worst,
          FP32_NUDGE_RATIO * nudge)
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
        f"({leaf}), rel-L2 {l2!r}, against the CPU's own move on "
        f"coefficients nudged by half an fp32 ulp: worst leaf {nudge!r} "
        f"({nudge_leaf}), rel-L2 {nudge_l2!r} over {NUDGE_DRAWS} draws (leaf "
        f"bar {FP32_NUDGE_RATIO} times it, {FP32_NUDGE_RATIO * nudge!r}); "
        f"updated parameters max-abs {p_err!r}, "
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
    counts = (int(first.optimizer.inner.count),
              int(second.optimizer.inner.count), first.step, second.step)
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


def eval_phase(device):
    """`cli test`'s device work on the card (phase 10): the 50-sample
    battery through ModelEvaluator on the full-width fp32 model and the
    production exact frontend. Returns the serving forward's launches."""
    import copy
    from vae_teb_tpu_torch import SeqVaeTeb, init_parameters
    from vae_teb_tpu_torch.data import DatasetStatsCalculator, build_dataset
    from vae_teb_tpu_torch.data.normalize import normalize_field_inplace
    from vae_teb_tpu_torch.eval import (GAINS_DEFAULT, SHIFT_SECONDS_DEFAULT,
                                        ModelEvaluator, seqvae_mse_test)
    from vae_teb_tpu_torch.kernels import (wavefront_bwd, wavefront_fwd,
                                           wavefront_fwd_plain)
    from vae_teb_tpu_torch.ops import PhaseScattering1D
    log("eval: the card has no matplotlib, so this phase drives the suite's "
        "device work through ModelEvaluator, not run_evaluation_suite, and "
        "writes no figure")
    failed, report = [], {}
    coeff_keys = ("fhr_st", "fhr_ph", "fhr_up_ph")

    def check(label, value, bar):
        log(f"eval: {label} {value!r} (bar {bar})")
        if not value <= bar:
            failed.append(f"{label} {value!r} > {bar}")

    def rel_max(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / np.abs(b).max())

    def rel_entry(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float((np.abs(a - b) / np.abs(b)).max())

    # windows: build-data's recipe through the exact frontend on the card
    # (7 records x 8 windows, seed 0), statistics over 2-minute trims, and
    # the two readers of `cli test`: trimmed + normalized, and raw
    exact = PhaseScattering1D(11, 4, 16, N, device=device)
    c_idx = exact.optimal_fhr_selection()["cross_selection"][
        "selected_indices"]
    parts = []
    build_dataset(None, n_records=7, windows_per_record=8, len_signal=N,
                  seed=0, transform=exact, write=parts.append)
    got = {k: np.concatenate([np.asarray(p[k]) for p in parts])
           for k in ("fhr", "up") + coeff_keys}
    if len(got["fhr"]) < EVAL_SAMPLES:
        raise AssertionError(f"eval: only {len(got['fhr'])} windows kept")
    calc = DatasetStatsCalculator(trim_minutes=2.0)
    for k in got:
        calc.update(k, got[k])
    stats = calc.finalize()
    got = {k: v[:EVAL_SAMPLES] for k, v in got.items()}
    trim_raw, trim_dec = calc.trim_raw, calc.trim_dec

    def norm(k, v):
        v = normalize_field_inplace(np.array(v, np.float32), k, stats[k],
                                    channel_axis=-2)
        return np.ascontiguousarray(np.swapaxes(v, 1, 2)) if v.ndim == 3 else v

    trimmed = {k: norm(k, got[k][:, :, trim_dec:-trim_dec])
               for k in coeff_keys}
    trimmed["fhr"] = norm("fhr", got["fhr"][:, trim_raw:-trim_raw])
    raw = {k: norm(k, got[k]) for k in coeff_keys}
    raw.update(fhr=got["fhr"], up=got["up"])
    batches = [{k: v[i:i + EVAL_BATCH] for k, v in trimmed.items()}
               for i in range(0, EVAL_SAMPLES, EVAL_BATCH)]
    chunks = [slice(i, i + EVAL_CHUNK)
              for i in range(0, EVAL_SAMPLES, EVAL_CHUNK)]

    model = init_parameters(SeqVaeTeb(), seed=INIT_SEED)
    cpu_model = copy.deepcopy(model)
    ev = ModelEvaluator(model, scattering=exact, stats=stats,
                        cross_subset=c_idx, device=device)
    n_shift, n_gain = len(SHIFT_SECONDS_DEFAULT), len(GAINS_DEFAULT)

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def recompute(method, variants, sl):
        return getattr(ev, method)(raw["fhr"][sl], raw["up"][sl],
                                   raw["fhr_st"][sl], raw["fhr_ph"][sl],
                                   variants)["te"]

    # the battery, counted from 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    wavefront_fwd.launches = wavefront_fwd.residual_launches = 0
    wavefront_bwd.launches = 0
    t0 = time.perf_counter()
    metrics, report["reconstruction_ms"] = timed(
        lambda: ev.reconstruction_analysis(batches))
    ablation, report["ablation_ms"] = timed(lambda: ev.up_ablation(batches))
    s0 = {k: trimmed[k][0] for k in trimmed}
    s1 = {k: trimmed[k][1] for k in trimmed}
    analysis, report["analyze_sample_ms"] = timed(lambda: ev.analyze_sample(
        s0["fhr_st"][None], s0["fhr_ph"][None], s0["fhr_up_ph"][None]))
    interp, report["latent_interpolation_ms"] = timed(
        lambda: ev.latent_interpolation(s0, s1, steps=8))
    battery, report["battery_ms"] = timed(
        lambda: seqvae_mse_test(model, batches, out_dir=None))
    shift_te, shift_ms, gain_te, gain_ms = [], [], [], []
    for sl in chunks:
        te, ms = timed(lambda: recompute("te_shift_analysis",
                                         SHIFT_SECONDS_DEFAULT, sl))
        shift_te.append(te)
        shift_ms.append(ms)
    shift_peak = torch.cuda.max_memory_allocated(device)
    for sl in chunks:
        te, ms = timed(lambda: recompute("up_gain_sweep", GAINS_DEFAULT, sl))
        gain_te.append(te)
        gain_ms.append(ms)
    torch.cuda.synchronize()
    report["battery_s"] = time.perf_counter() - t0
    launches = wavefront_fwd.launches
    other = wavefront_fwd.residual_launches + wavefront_bwd.launches
    report["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    shift_te, gain_te = np.concatenate(shift_te), np.concatenate(gain_te)

    # every encode launched the serving kernel, and nothing else ran
    encodes = 3 * len(batches) + 1 + 2 + len(batches) + 2 * len(chunks)
    log(f"eval: wavefront_fwd launched {launches} times in {encodes} encodes "
        f"(training kernels {other})")
    if launches != encodes or other:
        failed.append(f"{launches} serving launches in {encodes} encodes, "
                      f"{other} training launches")

    # shapes and finiteness
    seq, n_coeff = trimmed["fhr_st"].shape[1], sum(
        trimmed[k].shape[2] for k in ("fhr_st", "fhr_ph"))
    want_shapes = {"metrics": (metrics["kld"], (EVAL_SAMPLES,)),
                   "ablation": (ablation["te_without_up"], (EVAL_SAMPLES,)),
                   "te_map": (analysis["te_map"], (1, seq, 32)),
                   "interpolation": (interp["raw_mu"],
                                     (8, trimmed["fhr"].shape[1])),
                   "battery": (battery["mse"], (EVAL_SAMPLES, n_coeff)),
                   "shift": (shift_te, (EVAL_SAMPLES, n_shift)),
                   "gain": (gain_te, (EVAL_SAMPLES, n_gain))}
    for name, (arr, shape) in want_shapes.items():
        if arr.shape != shape or not np.isfinite(arr).all():
            failed.append(f"{name}: shape {arr.shape} (want {shape}), "
                          f"finite {np.isfinite(arr).all()}")
    if not all(np.isfinite(v).all() for d in (metrics, ablation, battery)
               for v in d.values()):
        failed.append("non-finite metrics, ablation or battery values")

    rows = [EVAL_CHUNK * n_shift] * (len(chunks) - 1) + [
        (EVAL_SAMPLES - EVAL_CHUNK * (len(chunks) - 1)) * n_shift]
    report["shift_ms"], report["gain_ms"] = shift_ms, gain_ms
    report["shift_windows_per_s"] = sum(rows) / (sum(shift_ms) / 1e3)
    report["gain_windows_per_s"] = EVAL_SAMPLES * n_gain / (
        sum(gain_ms) / 1e3)
    log(f"eval on {card()}: {len(chunks)} shift programs of up to "
        f"{max(rows)} rows, median {statistics.median(shift_ms)!r} ms, "
        f"{report['shift_windows_per_s']!r} windows/s; {len(chunks)} gain "
        f"programs of up to {EVAL_CHUNK * n_gain} rows, median "
        f"{statistics.median(gain_ms)!r} ms, "
        f"{report['gain_windows_per_s']!r} windows/s (CUDA events); "
        f"reconstruction {report['reconstruction_ms']!r} ms, ablation "
        f"{report['ablation_ms']!r} ms, analyze_sample "
        f"{report['analyze_sample_ms']!r} ms, latent interpolation "
        f"{report['latent_interpolation_ms']!r} ms, battery "
        f"{report['battery_ms']!r} ms; whole battery "
        f"{report['battery_s']!r} s (host clock); peak device memory "
        f"{report['peak_bytes']} bytes (through the shift programs "
        f"{shift_peak})")
    log(f"eval: mean VAF {metrics['vaf'].mean()!r}, MSE "
        f"{metrics['mse'].mean()!r}, SNR {metrics['snr_db'].mean()!r} dB, TE "
        f"{metrics['kld'].mean()!r}; TE with / without UP "
        f"{ablation['te_with_up'].mean()!r} / "
        f"{ablation['te_without_up'].mean()!r}")

    # shift 0 is gain 1.0, and the stored coefficients' TE
    zero = list(SHIFT_SECONDS_DEFAULT).index(0)
    one = list(GAINS_DEFAULT).index(1.0)
    check("TE at shift 0 vs gain 1.0, per entry relative",
          rel_entry(shift_te[:, zero], gain_te[:, one]), EVAL_SAME_CARD_TOL)
    check("TE at shift 0 vs up_ablation's te_with_up (stored coefficients), "
          "per entry relative",
          rel_entry(shift_te[:, zero], ablation["te_with_up"]),
          EVAL_SAME_CARD_TOL)

    # one B=244 shift program with the plain recurrence on the card
    model.recurrence = wavefront_fwd_plain
    try:
        plain = recompute("te_shift_analysis", SHIFT_SECONDS_DEFAULT,
                          chunks[0])
    finally:
        model.recurrence = wavefront_fwd
    check(f"TE grid of a {rows[0]}-row shift program, kernel vs plain "
          f"recurrence, max-abs/max", rel_max(shift_te[:EVAL_CHUNK], plain),
          SERVE_REL_TOL)

    # one sample's shift and gain rows on the CPU
    cpu = ModelEvaluator(cpu_model, scattering=PhaseScattering1D(11, 4, 16, N),
                         stats=stats, cross_subset=c_idx, device="cpu")
    args = [raw[k][0] for k in ("fhr", "up", "fhr_st", "fhr_ph")]
    cpu_shift = cpu.te_shift_analysis(*args)["te"]
    cpu_gain = cpu.up_gain_sweep(*args)["te"]
    check("sample 0 TE vs shift, card vs CPU, per entry relative",
          rel_entry(shift_te[0], cpu_shift), EVAL_CPU_TOL)
    check("sample 0 TE vs gain, card vs CPU, per entry relative",
          rel_entry(gain_te[0], cpu_gain), EVAL_CPU_TOL)
    check("sample 0 TE at gain 0, card vs CPU, max-abs/max",
          rel_max(gain_te[0, :1], cpu_gain[:1]), SERVE_REL_TOL)
    log(f"eval numbers: {json.dumps(report)}")
    if failed:
        raise AssertionError("eval checks failed:\n" + "\n".join(failed))
    return launches


def stream_export_phase(device):
    """Streaming sessions and serving artifacts on the card (phase 11).
    Returns (serving-kernel launches of the checked session chunks, of the
    checked calls of loaded programs)."""
    import copy
    import os
    import tempfile
    from vae_teb_tpu_torch import (SeqVaeTeb, StreamingSession,
                                   WindowFrontend, export_inference,
                                   export_source_stream, init_parameters,
                                   load_artifact, production_frontend,
                                   save_artifact)
    from vae_teb_tpu_torch.kernels import (wavefront_fwd, wavefront_fwd_plain,
                                           wavefront_recurrence)
    from vae_teb_tpu_torch.models import run_lstm_streams
    from vae_teb_tpu_torch.serve import COEFF_KEYS

    failed = []

    def check(name, value, tol):
        log(f"{name}: {value!r} (tol {tol})")
        if not value <= tol:
            failed.append(f"{name}: {value!r} > {tol}")

    def rel(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max().clamp_min(1e-30)).item()

    def launches_of(fn):
        wavefront_fwd.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, wavefront_fwd.launches

    frontend = WindowFrontend(production_frontend(device))
    gen = torch.Generator(device=device).manual_seed(11)
    x = torch.randn((2, 32, N), generator=gen, device=device)
    coeffs = frontend(x[0], x[1])
    x_ph = coeffs[2]                                   # (32, 300, 130)
    S = x_ph.shape[1]
    model = init_parameters(SeqVaeTeb(), seed=INIT_SEED).to(device).eval()
    with torch.inference_mode():
        full = model.source_encoder(x_ph)

    def chain(session, b, sizes, start=0):
        outs, lo = [], start
        for n in sizes:
            outs.append(session.step(x_ph[:b, lo:lo + n]))
            lo += n
        return torch.cat(outs, 1)

    stream_launches = 0
    for b in (1, 32):
        for sizes in (STREAM_CHUNKS, (1,) * STREAM_STEPS):
            session = StreamingSession(model, b, device)
            got, n = launches_of(lambda: chain(session, b, sizes))
            label = (f"session B={b}, {len(sizes)} chunks of "
                     f"{sizes if len(set(sizes)) > 1 else sizes[0]}")
            check(f"{label}: chained vs full source encode, max-abs/max",
                  rel(got, full[:b, :got.shape[1]]), STREAM_TOL)
            if n != len(sizes):
                failed.append(f"{label}: {n} kernel launches")
            stream_launches += n
    # the same session through the plain recurrence on the card
    kernel = chain(StreamingSession(model, 32, device), 32, STREAM_CHUNKS)
    model.recurrence = wavefront_fwd_plain
    try:
        plain = chain(StreamingSession(model, 32, device), 32, STREAM_CHUNKS)
    finally:
        model.recurrence = wavefront_recurrence
    check("session B=32, kernel vs plain recurrence on the card, "
          "max-abs/max", rel(kernel, plain), STREAM_TOL)
    # resume from a copy of the state after the first two chunks
    session = StreamingSession(model, 32, device)
    chain(session, 32, STREAM_CHUNKS[:2])
    saved = copy.deepcopy(session.state)
    rest = chain(session, 32, STREAM_CHUNKS[2:], sum(STREAM_CHUNKS[:2]))
    resumed = StreamingSession(model, 32, device)
    resumed.state = saved
    again = chain(resumed, 32, STREAM_CHUNKS[2:], sum(STREAM_CHUNKS[:2]))
    log(f"session resumed from a copied state: bit for bit "
        f"{torch.equal(rest, again)}")
    if not torch.equal(rest, again):
        failed.append(f"resumed session differs by {rel(again, rest)!r}")
    # B=1 against a CPU session
    card = chain(StreamingSession(model, 1, device), 1, STREAM_CHUNKS)
    cpu_session = StreamingSession(copy.deepcopy(model).cpu(), 1, "cpu")
    outs, lo = [], 0
    for n in STREAM_CHUNKS:
        outs.append(cpu_session.step(x_ph[:1, lo:lo + n].cpu()))
        lo += n
    check("session B=1, card vs CPU, max-abs/max",
          rel(card.cpu(), torch.cat(outs, 1)), STREAM_CPU_TOL)
    # the bf16 policy: the recurrence carries the bf16 state exactly; the
    # layers around it round a bf16 product a ulp apart when cuBLAS or
    # cuDNN sum another number of rows in another order, as the full encode
    # does between batch layouts
    m16 = SeqVaeTeb(dtype=torch.bfloat16)
    m16.load_state_dict(model.state_dict())
    m16 = m16.to(device).eval()
    se16 = m16.source_encoder
    with torch.inference_mode():
        full16 = se16(x_ph)
        rows16 = torch.cat([se16(x_ph[i:i + 1]) for i in range(32)])
        pre = se16.pre_lstm(x_ph)
        ((want, _),) = run_lstm_streams([se16.lstm(pre)])
        outs, lo, state = [], 0, None
        for n in STREAM_CHUNKS:
            ((y, state),) = run_lstm_streams([se16.lstm(pre[:, lo:lo + n],
                                                        state)])
            outs.append(y)
            lo += n
    log(f"bf16 LSTM chained over chunks {STREAM_CHUNKS} from its bf16 state "
        f"vs one pass, on identical inputs: bit for bit "
        f"{torch.equal(torch.cat(outs, 1), want)}")
    if not torch.equal(torch.cat(outs, 1), want):
        failed.append("bf16 LSTM chained vs one pass differs by "
                      f"{rel(torch.cat(outs, 1), want)!r}")
    got16 = chain(StreamingSession(m16, 32, device), 32, STREAM_CHUNKS)
    move = rel(rows16, full16)
    log(f"bf16 full source encode B=32 vs its rows encoded one by one, "
        f"max-abs/max: {move!r}")
    check("bf16 session B=32 vs bf16 full source encode, max-abs/max",
          rel(got16, full16), BF16_STREAM_TOL)
    del m16, se16

    # per-chunk latency beside the full recompute of the reference's API
    for b in (1, 32):
        session = StreamingSession(model, b, device)
        for n in (1, 30):
            chunk = x_ph[:b, :n].contiguous()
            ms = cuda_time_ms(lambda: session.step(chunk))
            log(f"stream B={b} chunk {n}: {ms!r} ms a chunk (CUDA events, "
                f"median of {TIMED_RUNS})")
        with torch.inference_mode():
            ms = cuda_time_ms(lambda: model.get_sequence_encoding(x_ph[:b],
                                                                  S - 1))
        log(f"get_sequence_encoding B={b} (the full {S}-step source encode "
            f"a call): {ms!r} ms")

    # the inference artifact, both flavours, traced at B=2
    export_launches = 0
    example = {k: c[:2] for k, c in zip(COEFF_KEYS, coeffs)}
    with tempfile.TemporaryDirectory() as tmp:
        for bundle in (False, True):
            flavour = "bundled" if bundle else "weights as argument"
            t = time.perf_counter()
            program = export_inference(model, example, bundle_params=bundle,
                                       device=device)
            export_s = time.perf_counter() - t
            path = os.path.join(tmp, "inference.pt2")
            nbytes = save_artifact(program, path)
            del program
            t = time.perf_counter()
            loaded = load_artifact(path).module()
            load_s = time.perf_counter() - t
            weights = () if bundle else (model.state_dict(),)
            log(f"inference artifact, {flavour}: {nbytes} bytes, export "
                f"{export_s:.2f} s, load {load_s:.2f} s")
            for b in ARTIFACT_BATCHES:
                args = tuple(c[:b] for c in coeffs)
                with torch.inference_mode():
                    want = model(*args)
                    got, n = launches_of(lambda: loaded(*weights, *args))
                check(f"loaded program ({flavour}) B={b} vs live model, "
                      f"worst max-abs/max",
                      max(rel(got[k], want[k]) for k in OUT_KEYS), EXPORT_TOL)
                if n != 1:
                    failed.append(f"loaded program ({flavour}) B={b}: {n} "
                                  f"kernel launches")
                export_launches += n
            with torch.inference_mode():
                args = tuple(c[:32] for c in coeffs)
                ms = cuda_time_ms(lambda: loaded(*weights, *args))
                live_ms = cuda_time_ms(lambda: model(*args))
            log(f"B=32 request, {flavour}: loaded program {ms!r} ms, live "
                f"model {live_ms!r} ms (CUDA events, median of {TIMED_RUNS})")
            os.remove(path)
            del loaded

        # the stream artifact at B=32, chunk 1, against a session
        program = export_source_stream(model, batch_size=32, chunk_len=1,
                                       n_channels=x_ph.shape[-1],
                                       device=device)
        path = os.path.join(tmp, "stream.pt2")
        nbytes = save_artifact(program, path)
        step = load_artifact(path).module()
        state = model.init_source_stream_state(32)
        weights = model.state_dict()
        outs = []
        wavefront_fwd.launches = 0
        with torch.inference_mode():
            for t in range(ARTIFACT_STEPS):
                mu, state = step(weights, x_ph[:, t:t + 1], state)
                outs.append(mu)
        torch.cuda.synchronize()
        n = wavefront_fwd.launches
        want = chain(StreamingSession(model, 32, device), 32,
                     (1,) * ARTIFACT_STEPS)
        check(f"stream artifact ({nbytes} bytes) B=32, {ARTIFACT_STEPS} steps "
              f"of 1 vs a session, max-abs/max", rel(torch.cat(outs, 1), want),
              EXPORT_TOL)
        if n != ARTIFACT_STEPS:
            failed.append(f"stream artifact: {n} launches in {ARTIFACT_STEPS} "
                          f"steps")
        export_launches += n
    log(f"phase 11 serving-kernel launches: {stream_launches} in the checked "
        f"session chunks, {export_launches} in the checked program calls")
    if failed:
        raise AssertionError("stream / export checks failed:\n"
                             + "\n".join(failed))
    return stream_launches, export_launches


# Phase 12: the grid kernels at the shapes the cluster kernels refuse,
# (depths, H): the forecast decoder's LSTM(256, 3), the predict-st
# decoder's LSTM(256, 2), two 4-layer H=128 encoders and two 5-layer H=64
# encoders; each at B=32, S=300 in fp32 and bf16, all timed
GRID_KERNEL_CASES = (((3,), 256), ((2,), 256), ((4, 4), 128), ((5, 5), 64))
VARIANT_STEPS = 4        # timed train steps of each variant at B=32
CLASSIFIER_STEPS = 10    # frozen classifier steps on a separable labelling
CLASSIFIER_LR = 3e-3     # the JAX package's own trainer test's rate


def check_grid_kernels(device, S=300):
    """Phase 12 (a): the grid kernels against their plain versions, with
    their plans, CUDA-event times, bounds and the cuDNN yardstick (held to
    the kernel at 1e-4 of max in fp32, its distance reported in bf16).
    Returns {(depths, H): check_kernels' results}."""
    out = {}
    for depths, H in GRID_KERNEL_CASES:
        cases = tuple((depths, 32, dtype, True)
                      for dtype in (torch.float32, torch.bfloat16))
        out[(depths, H)] = check_kernels(
            device, S, H, cases, {torch.float32: LIBRARY_REL_TOL[torch.float32]})
    return out


def _entry_counts():
    from vae_teb_tpu_torch.kernels import wavefront_bwd, wavefront_fwd
    return Counter(wavefront_fwd.entry_launches) + Counter(
        wavefront_bwd.entry_launches)


def _launched(fn):
    """(fn(), the kernel entry points it launched, by count)."""
    before = _entry_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, dict(_entry_counts() - before)


def variant_step(model, optimizer, batch, loss_fn, eps):
    """One train step of a forecast or predict-st model: the train-mode
    forward with the given noise, loss_fn(out, batch), backward, and the
    clipped AdamW update. Returns the losses as floats."""
    out = model.train()(batch["fhr_st"], batch["fhr_ph"], batch["fhr_up_ph"],
                        deterministic=False, eps=eps)
    losses = loss_fn(out, batch)
    optimizer.zero_grad(set_to_none=True)
    losses["total_loss"].backward()
    optimizer.step()
    return {k: v.item() for k, v in losses.items()}


def variant_phase(device, name, make_model, loss_fn, frontend, gen, expect):
    """Phase 12 (b) and (d): a full-width variant on seeded raw windows
    through the production frontend. VARIANT_STEPS train steps at B=32
    (each launching `expect`: one cluster launch for the encoders and one
    grid launch for the decoder's LSTM, each way), finite losses, median
    step time; from the seeded weights, one B=8 step's gradients through
    the kernels against the plain reverse wavefront behind the same
    forward (phase 5's bar, per leaf), and one B=2 step against the CPU
    on identical coefficients and noise (phase 5's bars). Returns (the
    trained model, the fixed batch, the launches of the steps)."""
    import copy
    from vae_teb_tpu_torch.kernels import wavefront_bwd, wavefront_bwd_plain
    from vae_teb_tpu_torch.train import make_optimizer
    seeded = make_model()
    model = copy.deepcopy(seeded).to(device)
    opt = lambda m: make_optimizer(list(m.parameters()), 1e-4, 0.5, 1e-4)
    optimizer = opt(model)

    def batch_of(b):
        x = torch.randn((2, b, N), generator=gen, device=device)
        coeffs = frontend(x[0], x[1])
        batch = dict(zip(("fhr_st", "fhr_ph", "fhr_up_ph"), coeffs))
        S = coeffs[0].shape[1]
        batch["fhr"] = torch.randn((b, 16 * S), generator=gen, device=device)
        return batch, torch.randn((b, S, 32), generator=gen, device=device)

    failed = []
    batch, eps = batch_of(32)
    times, launched_total = [], Counter()
    for step in range(VARIANT_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses, launched = _launched(
            lambda: variant_step(model, optimizer, batch, loss_fn, eps))
        if step:
            times.append(time.perf_counter() - t)
        launched_total.update(launched)
        log(f"{name} B=32 step {step}: " + ", ".join(
            f"{k} {v!r}" for k, v in sorted(losses.items()))
            + f"; launched {launched}")
        if launched != expect:
            failed.append(f"{name} step {step} launched {launched}, "
                          f"expected {expect}")
        if not all(np.isfinite(v) for v in losses.values()):
            failed.append(f"{name} step {step}: non-finite losses {losses}")
    log(f"{name} B=32: median step {statistics.median(times) * 1e3!r} ms "
        f"(forward, loss, backward, AdamW; without the frontend) over "
        f"{len(times)} steps after a warm-up")

    small, eps8 = batch_of(8)
    wavefront_module = sys.modules["vae_teb_tpu_torch.kernels.wavefront"]
    grads = {}
    for kind in ("kernels", "plain backward"):
        m = copy.deepcopy(seeded).to(device)
        if kind == "plain backward":
            wavefront_module.wavefront_bwd = wavefront_bwd_plain
        try:
            variant_step(m, opt(m), small, loss_fn, eps8)
        finally:
            wavefront_module.wavefront_bwd = wavefront_bwd
        grads[kind] = {k: p.grad for k, p in m.named_parameters()}
        del m
    worst, leaf, l2 = grad_report(grads["kernels"], grads["plain backward"])
    log(f"{name} step kernels vs plain backward (B=8, one forward): "
        f"{len(grads['kernels'])} gradient leaves, worst max-abs/max "
        f"{worst!r} ({leaf}; bar {GRAD_REL_TOL}), rel-L2 {l2!r}")
    if not (worst <= GRAD_REL_TOL and l2 <= GRAD_REL_TOL):
        failed.append(f"{name} kernels vs plain backward: {worst} ({leaf}), "
                      f"rel-L2 {l2}")
    del grads

    two, eps2 = batch_of(2)
    gpu_model = copy.deepcopy(seeded).to(device)
    cpu_model = copy.deepcopy(seeded)
    l_gpu = variant_step(gpu_model, opt(gpu_model), two, loss_fn, eps2)
    l_cpu = variant_step(cpu_model, opt(cpu_model),
                         {k: v.cpu() for k, v in two.items()}, loss_fn,
                         eps2.cpu())
    loss_err = max(abs(l_gpu[k] / l_cpu[k] - 1) for k in l_cpu if l_cpu[k])
    worst, leaf, l2 = grad_report(
        {k: p.grad.cpu() for k, p in gpu_model.named_parameters()},
        {k: p.grad for k, p in cpu_model.named_parameters()})
    log(f"{name} step card vs CPU (B=2, identical coefficients and noise): "
        f"losses rel {loss_err!r} (bar {METRIC_REL_TOL}); gradients worst "
        f"max-abs/max {worst!r} ({leaf}; bar {KINK_REL_TOL}), rel-L2 {l2!r} "
        f"(bar {KINK_L2_TOL})")
    if not (loss_err <= METRIC_REL_TOL and worst <= KINK_REL_TOL
            and l2 <= KINK_L2_TOL):
        failed.append(f"{name} card vs CPU: losses {loss_err}, gradients "
                      f"{worst} ({leaf}), rel-L2 {l2}")
    if failed:
        raise AssertionError(f"{name} checks failed:\n" + "\n".join(failed))
    return model, batch, launched_total


def variants_phase(device):
    """Phase 12 (b)-(e): the forecast, conv-window, predict-st and
    classifier families at full width on the card. Returns the kernel
    entry points' launches over the phase's model runs (the comparisons
    with plain versions and the CPU excluded)."""
    from vae_teb_tpu_torch import (SeqVaeTeb, WindowFrontend, init_parameters,
                                   production_frontend)
    from vae_teb_tpu_torch.eval import prediction_accuracy_test
    from vae_teb_tpu_torch.models import (SeqVaeTebClassifier,
                                          SeqVaeTebForecast,
                                          SeqVaeTebPredictSt)
    from vae_teb_tpu_torch.train import ClassifierConfig, ClassifierTrainer

    frontend = WindowFrontend(production_frontend(device))
    gen = torch.Generator(device=device).manual_seed(12)
    grid = {"wavefront_fwd_res_f32": 1, "wavefront_grid_fwd_res_f32": 1,
            "wavefront_bwd_f32": 1, "wavefront_grid_bwd_f32": 1}
    main_path = Counter()

    # (b) the direct-window forecaster
    forecast_loss = lambda out, b: SeqVaeTebForecast.compute_loss(
        out, b["fhr"], beta=1e-5)
    model, batch, n = variant_phase(
        device, "forecast (direct)",
        lambda: init_parameters(SeqVaeTebForecast(
            decoder_type="direct", prediction_horizon=480), seed=INIT_SEED),
        forecast_loss, frontend, gen, grid)
    main_path.update(n)
    del model

    # (c) the conv-window decoder at B=8: forward and loss, train mode
    conv = init_parameters(SeqVaeTebForecast(decoder_type="conv_window"),
                           seed=INIT_SEED)
    small = {k: v[:8] for k, v in batch.items()}
    S = batch["fhr_st"].shape[1]
    eps = torch.randn((8, S, 32), generator=gen, device=device)

    def conv_forward(m, b, e):
        with torch.no_grad():
            out = m.train()(b["fhr_st"], b["fhr_ph"], b["fhr_up_ph"],
                            deterministic=False, eps=e)
            return out, forecast_loss(out, b)
    (out, losses), n = _launched(lambda: conv_forward(conv.to(device), small,
                                                      eps))
    main_path.update(n)
    cpu_out, cpu_losses = conv_forward(
        conv.cpu(), {k: v.cpu() for k, v in small.items()}, eps.cpu())
    rel = max(((out[k].cpu() - cpu_out[k]).abs().max()
               / cpu_out[k].abs().max().clamp_min(1e-30)).item()
              for k in ("window_mu", "window_logvar"))
    loss_rel = abs(losses["total_loss"].item()
                   / cpu_losses["total_loss"].item() - 1)
    finite = all(torch.isfinite(v).all().item() for v in out.values())
    log(f"conv-window forecast B=8 (train mode): window_mu "
        f"{tuple(out['window_mu'].shape)}, total_loss "
        f"{losses['total_loss'].item()!r}, finite {finite}, launched {n}; "
        f"against a CPU run, window outputs max-abs/max {rel!r} (bar "
        f"{SERVE_REL_TOL}), total_loss rel {loss_rel!r} (bar "
        f"{METRIC_REL_TOL})")
    if (tuple(out["window_mu"].shape) != (8, S, 480) or not finite
            or n != {"wavefront_fwd_f32": 1} or not rel <= SERVE_REL_TOL
            or not loss_rel <= METRIC_REL_TOL):
        raise AssertionError("conv-window forecast: bad shape, non-finite "
                             f"values, launches {n} or card vs CPU {rel}, "
                             f"{loss_rel}")
    del conv, out, cpu_out

    # (d) predict-st, then its chained-prediction battery on 8 windows
    predict_loss = lambda out, b: SeqVaeTebPredictSt.compute_loss(
        out, b["fhr_st"], b["fhr_ph"], beta=1e-5)
    model, batch, n = variant_phase(
        device, "predict-st",
        lambda: init_parameters(SeqVaeTebPredictSt(prediction_horizon=30),
                                seed=INIT_SEED),
        predict_loss, frontend, gen, grid)
    main_path.update(n)
    windows = [{k: v[i:i + 4] for k, v in batch.items()} for i in (0, 4)]
    t = time.perf_counter()
    res, n = _launched(lambda: prediction_accuracy_test(model, windows,
                                                        prediction_idx=30))
    main_path.update(n)
    finite = all(np.isfinite(v).all() for v in res.values())
    log(f"prediction_accuracy_test (8 windows, prediction_idx 30): "
        f"{time.perf_counter() - t:.3f} s, keys {sorted(res)}, "
        f"scattering_mse {res['scattering_mse'].shape} mean "
        f"{res['scattering_mse'].mean()!r}, phase_mse mean "
        f"{res['phase_mse'].mean()!r}, finite {finite}, launched {n}")
    if (not finite or res["scattering_mse"].shape
            != (8, batch["fhr_st"].shape[2])
            or n != {"wavefront_fwd_f32": 2, "wavefront_grid_fwd_f32": 2}):
        raise AssertionError(f"prediction_accuracy_test: finite {finite}, "
                             f"launches {n}")
    del model

    # (e) the classifier: a pretrained (seeded) VAE, frozen steps, a joint
    # step, predict
    vae = init_parameters(SeqVaeTeb(), seed=INIT_SEED)
    make = lambda freeze: SeqVaeTebClassifier(freeze_vae=freeze)
    trainer = ClassifierTrainer(make(True), ClassifierConfig(
        lr=CLASSIFIER_LR), device)
    copied = trainer.init_state(vae.state_dict())
    vae_keys = len(vae.state_dict())
    log(f"classifier: transfer_params copied {len(copied)} of the VAE's "
        f"{vae_keys} entries")
    if len(copied) != vae_keys:
        raise AssertionError("transfer_params missed VAE entries")
    labels = torch.arange(32, device=device) % 2
    cls_batch = {k: v.clone() for k, v in batch.items()}
    cls_batch["fhr_up_ph"][labels == 1, :, :8] += 3.0   # separable
    cls_batch["label"] = labels
    frozen_before = trainer.model.vae_model.decoder.output_mu.dense[0
                                                                    ].weight.clone()
    losses, times = [], []
    for step in range(CLASSIFIER_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m, n = _launched(lambda: trainer.train_step(cls_batch))
        if step:
            times.append(time.perf_counter() - t)
        main_path.update(n)
        losses.append(m["loss"].item())
        if n != {"wavefront_fwd_f32": 1}:
            raise AssertionError(f"frozen classifier step {step} launched "
                                 f"{n}: the frozen VAE runs the serving "
                                 "forward only")
    cfg = trainer.config
    decay = (frozen_before * (1 - cfg.lr * cfg.weight_decay) ** CLASSIFIER_STEPS
             - trainer.model.vae_model.decoder.output_mu.dense[0].weight)
    decay_err = (decay.abs().max() / frozen_before.abs().max()).item()
    log(f"classifier frozen B=32: losses {losses}, median step "
        f"{statistics.median(times) * 1e3!r} ms; a frozen VAE weight after "
        f"{CLASSIFIER_STEPS} steps against p (1 - lr wd)^n, max-abs/max "
        f"{decay_err!r}")
    if not (losses[-1] < losses[0] and np.isfinite(losses).all()
            and decay_err <= 1e-5):
        raise AssertionError(f"frozen classifier: losses {losses}, decay "
                             f"{decay_err}")
    logits, probs = trainer.predict(cls_batch)
    acc = float((probs.argmax(-1) == labels.cpu().numpy()).mean())
    log(f"classifier predict B=32: probabilities {probs.shape}, accuracy "
        f"{acc!r} on the training batch")
    if probs.shape != (32, 2) or not np.isfinite(probs).all():
        raise AssertionError("classifier predict: bad probabilities")
    joint = ClassifierTrainer(make(False), ClassifierConfig(
        lr=CLASSIFIER_LR, vae_loss_weight=0.1), device)
    joint.init_state(vae.state_dict())
    torch.cuda.synchronize()
    t = time.perf_counter()
    m, n = _launched(lambda: joint.train_step(cls_batch))
    main_path.update(n)
    m = {k: v.item() for k, v in m.items()}
    log(f"classifier joint step B=32: {m}, {(time.perf_counter() - t) * 1e3!r}"
        f" ms (the first, with its warm-up), launched {n}")
    if (n != {"wavefront_fwd_res_f32": 1, "wavefront_bwd_f32": 1}
            or not np.isfinite(list(m.values())).all()
            or abs(m["loss"] - m["classification_loss"] - 0.1 * m["vae_loss"])
            > 1e-5 * abs(m["loss"])):
        raise AssertionError(f"joint classifier step: {m}, launches {n}")
    log(f"phase 12 launches: {dict(main_path)}")
    return main_path


# Phase 13: data- and tensor-parallel training on the one card. Ranks are
# processes (torch.multiprocessing, spawn) that share cuda:0 over gloo
# ((a), (c)), or a one-rank NCCL world ((b), (d)). They load the kernels
# the parent built from the same build directory.
PARALLEL_BATCH = 64        # global batch of (a)-(c)
PARALLEL_STEPS = 3         # steps of (a) and (b); (c) takes 2
HYBRID_STEPS = 2
PARALLEL_TIMEOUT_S = 480   # a spawned world's limit, its start included
CLI_TIMEOUT_S = 300        # (d)'s torchrun world
CLI_WINDOWS = 64           # (d)'s packed store: 2 steps of 32


def nudge_bar(coeffs, gen):
    """The coefficients moved by about half an fp32 ulp each (a relative
    2^-24 times a standard normal, rounded to fp32): the input of the
    gradient-sensitivity runs that set the fp32 leaf bars."""
    return [(c.double() * (1 + 2 ** -24 * torch.randn(
        c.shape, generator=gen, device=c.device, dtype=torch.float64))
             ).float() for c in coeffs]


_LAUNCHES = Counter()   # a phase-13 rank's launches, by entry and batch


def _spy_launches():
    """Count (entry point, batch) of every kernel launch from here on in
    _LAUNCHES, emptied; returns it."""
    _LAUNCHES.clear()
    wmod = sys.modules["vae_teb_tpu_torch.kernels.wavefront"]
    if getattr(wmod._launch, "spied", False):
        return _LAUNCHES
    seen, launch = _LAUNCHES, wmod._launch

    def spy(kind, entry, plan, ptrs, K, B, *rest):
        name = launch(kind, entry, plan, ptrs, K, B, *rest)
        seen[f"{name} B={B}"] += 1
        return name
    spy.spied = True
    wmod._launch = spy
    return seen


def _grads(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _state_bytes(trainer):
    """(parameter bytes, Adam moment bytes) this rank holds."""
    params = list(trainer.model.parameters())
    st = trainer.optimizer.state
    return (sum(p.numel() * p.element_size() for p in params),
            sum(st[p][m].numel() * st[p][m].element_size()
                for p in params if p in st for m in ("mu", "nu")))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _param_move(after, ref_state, before, lr):
    """(share of weights more than lr/100 apart, rel-L2 of the difference
    over the update, running statistics' max-abs over max) of `after`
    against `ref_state`, both one step from `before` (state_dicts)."""
    n = far = num = den = 0
    s_err = 0.0
    for k, w in ref_state.items():
        d = after[k].float() - w.float()
        if k.endswith(("running_mean", "running_var")):
            s_err = max(s_err, (d.abs().max() / w.abs().max()
                                .clamp_min(1e-30)).item())
            continue
        n += d.numel()
        far += (d.abs() > 1e-2 * lr).sum().item()
        num += d.square().sum().item()
        den += (w.float() - before[k].float()).square().sum().item()
    return far / n, (num / den) ** 0.5, s_err


def _forced_checks(label, snaps, steps, spec, device):
    """Rank 0's checks of a mesh run: each step against the plain Trainer
    from the run's full state before it, on the global batch and noise.
    `steps`: per step (metrics, full model state after it, gradients of
    step 1 or None). Bars: losses and BatchNorm statistics METRIC_REL_TOL;
    the rest FP32_NUDGE_RATIO times what the plain step from the same
    state moves when its coefficients move by half an fp32 ulp (the larger
    move of NUDGE_DRAWS draws, per measure): the gradients' worst leaf and
    rel-L2 (grad_norm, which moves by no more than the rel-L2), the
    parameters' share more than lr/100 apart and rel-L2 of the update.
    The share depends on the state (how many weights an Adam step leaves
    near zero), so each step's bar is measured from that step's state.
    Returns the failures."""
    from vae_teb_tpu_torch import SeqVaeTeb, Trainer, TrainerConfig
    cfg = TrainerConfig()
    ref = Trainer(SeqVaeTeb(**spec["model"]), cfg, device)
    r = FP32_NUDGE_RATIO
    failed = []

    def check(name, value, bar):
        if not value <= bar:
            failed.append(f"{label} {name}: {value!r} > {bar!r}")

    for i, (snap, (metrics, after, grads)) in enumerate(zip(snaps, steps)):
        batch = {k: v.to(device) for k, v in spec["batches"][i].items()}
        eps = spec["eps"][i].to(device)
        ref.load_state_dict(snap)
        want = {k: v.item() for k, v in ref.train_step(
            batch, spec["beta"], eps=eps).items()}
        want_state = {k: v.clone() for k, v in ref.model.state_dict().items()}
        want_grads = _grads(ref.model)
        # the plain step's own sensitivity from this state
        gen = torch.Generator(device=device).manual_seed(13 + i)
        nudge, leaves = {}, []
        for _ in range(NUDGE_DRAWS):
            ref.load_state_dict(snap)
            nudged = dict(batch)
            nudged.update(zip(("fhr_st", "fhr_ph", "fhr_up_ph"), nudge_bar(
                [batch["fhr_st"], batch["fhr_ph"], batch["fhr_up_ph"]], gen)))
            ref.train_step(nudged, spec["beta"], eps=eps)
            worst, leaf, g_l2 = grad_report(_grads(ref.model), want_grads)
            share, p_l2, _ = _param_move(ref.model.state_dict(), want_state,
                                         snap["model"], cfg.lr)
            for k, v in (("grad_worst", worst), ("grad_l2", g_l2),
                         ("share", share), ("param_l2", p_l2)):
                nudge[k] = max(nudge.get(k, 0.0), v)
            leaves.append(leaf)
        loss_err = max(abs(metrics[k] / want[k] - 1) for k in want
                       if k != "grad_norm")
        norm_err = abs(metrics["grad_norm"] / want["grad_norm"] - 1)
        frac, l2, s_err = _param_move(after, want_state, snap["model"],
                                      cfg.lr)
        line = (f"{label} step {i + 1} against the plain Trainer from its "
                f"state: losses rel {loss_err!r}, grad_norm rel {norm_err!r} "
                f"({metrics['grad_norm']!r} / {want['grad_norm']!r}), "
                f"parameters: share more than lr/100 apart {frac!r}, rel-L2 "
                f"of the update {l2!r}; running statistics {s_err!r}")
        check(f"step {i + 1} losses", loss_err, METRIC_REL_TOL)
        check(f"step {i + 1} running statistics", s_err, METRIC_REL_TOL)
        check(f"step {i + 1} grad_norm", norm_err, r * nudge["grad_l2"])
        check(f"step {i + 1} parameter share", frac, r * nudge["share"])
        check(f"step {i + 1} parameter rel-L2", l2, r * nudge["param_l2"])
        if grads is not None:
            worst, leaf, g_l2 = grad_report(grads, want_grads)
            line += (f"; gradients worst max-abs/max {worst!r} ({leaf}), "
                     f"rel-L2 {g_l2!r}")
            check(f"step {i + 1} gradients, worst leaf {leaf}", worst,
                  r * nudge["grad_worst"])
            check(f"step {i + 1} gradients rel-L2", g_l2, r * nudge["grad_l2"])
        log(line + f"; the plain step from the same state when the "
            f"coefficients move by half an fp32 ulp (the larger of "
            f"{NUDGE_DRAWS} draws): gradients worst leaf "
            f"{nudge['grad_worst']!r} ({leaves}), rel-L2 {nudge['grad_l2']!r}"
            f", parameters share {nudge['share']!r}, rel-L2 of the update "
            f"{nudge['param_l2']!r}; the bars are {r} times these")
    return failed


def _mesh_part(spec, info, device, n_model, n_steps, label):
    """One mesh run of the full-width model from the seeded weights: each
    rank steps on its rows of the global batches with the global noise.
    Every rank reports its metrics, step times, kernel launches and state
    bytes; rank 0 also checks each step against the plain Trainer."""
    import copy
    from vae_teb_tpu_torch import SeqVaeTeb, Trainer, TrainerConfig, init_parameters
    from vae_teb_tpu_torch.parallel import (data_parallel_mesh, hybrid_mesh,
                                            shard_batch)
    mesh = (data_parallel_mesh() if n_model == 1 else
            hybrid_mesh(info.world_size // n_model, n_model))
    model = init_parameters(SeqVaeTeb(**spec["model"]), seed=INIT_SEED)
    trainer = Trainer(model, TrainerConfig(tp_min_dim=spec["tp_min_dim"]),
                      mesh=mesh)
    seen = _spy_launches()
    snaps, steps, times = [], [], []
    for i in range(n_steps):
        snaps.append(copy.deepcopy(trainer.state_dict()))   # a collective
        batch = shard_batch({k: v.to(device) for k, v in
                             spec["batches"][i].items()}, mesh)
        _sync(device)
        t0 = time.perf_counter()
        m = trainer.train_step(batch, spec["beta"],
                               eps=spec["eps"][i].to(device))
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        metrics = {k: v.item() for k, v in m.items()}
        grads = _grads(trainer.model) if i == 0 and n_model == 1 else None
        after = {k: v.clone() for k, v in trainer.state_dict()["model"].items()}
        steps.append((metrics, after, grads))
    params, moments = _state_bytes(trainer)
    rank = info.rank
    out = {"metrics": [s[0] for s in steps], "step_ms": times,
           "launches": dict(seen), "param_bytes": params,
           "moment_bytes": moments, "mesh": repr(mesh), "failed": []}
    if rank == 0:
        out["failed"] = _forced_checks(label, snaps, steps, spec, device)
    return out


def _nccl_part(spec, info, device):
    """(b): a one-rank NCCL world through the data-parallel path against
    the plain Trainer on the same seeded weights, batches and noise. The
    collectives of a world of one leave every value as it is (checked
    directly); the first step's forward is bit for bit (losses, batch
    statistics); step 1's gradients (worst leaf) and the parameters after
    PARALLEL_STEPS steps (rel-L2 of the difference over the update) are
    no further from the plain Trainer's than twice two plain Trainers'
    distance from each other: the card's backward adds with atomics in
    places (F.interpolate's), so two plain runs differ too, by an amount
    that varies between samples. Step times of both paths, host clock,
    synchronized."""
    from vae_teb_tpu_torch import SeqVaeTeb, Trainer, TrainerConfig, init_parameters
    from vae_teb_tpu_torch.parallel import (all_reduce_mean_,
                                            data_parallel_mesh)
    runs, failed = {}, []
    seen = _spy_launches()
    for name in ("plain", "mesh", "plain again"):
        model = init_parameters(SeqVaeTeb(**spec["model"]), seed=INIT_SEED)
        mesh = data_parallel_mesh() if name == "mesh" else None
        trainer = Trainer(model, TrainerConfig(), device=device, mesh=mesh)
        metrics, times = [], []
        for i in range(PARALLEL_STEPS):
            batch = {k: v.to(device) for k, v in spec["batches"][i].items()}
            _sync(device)
            t0 = time.perf_counter()
            m = trainer.train_step(batch, spec["beta"],
                                   eps=spec["eps"][i].to(device))
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: v.item() for k, v in m.items()})
            if i == 0:
                grads = _grads(trainer.model)
                stats = {k: b.clone() for k, b in trainer.model.named_buffers()}
        if name == "mesh":   # the world of one's collectives, directly
            probe = [g.clone() for g in grads.values()]
            all_reduce_mean_(probe, mesh.group("data"), 1)
            exact = all(torch.equal(p, g) for p, g in zip(probe,
                                                           grads.values()))
            avg = trainer.runner.mean({k: torch.tensor(v, device=device)
                                       for k, v in metrics[0].items()})
            exact = exact and all(avg[k].item() == metrics[0][k]
                                  for k in avg)
            if not exact:
                failed.append("(b) a world of one's all_reduce changed a value")
        runs[name] = (metrics, times, grads, stats, {
            k: v.clone() for k, v in trainer.model.state_dict().items()})
        del trainer, model

    seeded = init_parameters(SeqVaeTeb(**spec["model"]), seed=INIT_SEED
                             ).to(device).state_dict()
    mesh, plain, again = runs["mesh"], runs["plain"], runs["plain again"]
    losses_equal = all(mesh[0][0][k] == plain[0][0][k]
                       for k in plain[0][0] if k != "grad_norm")
    stats_equal = all(torch.equal(mesh[3][k], plain[3][k]) for k in plain[3])
    g_mesh, g_again = (grad_report(mesh[2], plain[2])[0],
                       grad_report(again[2], plain[2])[0])
    p_mesh, p_again = (_param_move(mesh[4], plain[4], seeded, 1e-4)[1],
                       _param_move(again[4], plain[4], seeded, 1e-4)[1])
    log(f"(b) one-rank NCCL world vs the plain Trainer ({PARALLEL_STEPS} steps "
        f"at B={PARALLEL_BATCH}): step-1 losses bit for bit {losses_equal}, "
        f"batch statistics bit for bit {stats_equal}; step-1 gradients worst "
        f"max-abs/max {g_mesh!r} (plain vs plain {g_again!r}); parameters "
        f"after {PARALLEL_STEPS} steps rel-L2 of the update {p_mesh!r} "
        f"(plain vs plain {p_again!r}); median step ms after a warm-up (plain, NCCL path, "
        f"plain again, in that order): {statistics.median(plain[1][1:])!r}, "
        f"{statistics.median(mesh[1][1:])!r}, "
        f"{statistics.median(again[1][1:])!r} ({spec['card']})")
    if not (losses_equal and stats_equal):
        failed.append("(b) the forward is not bit for bit")
    if not (g_mesh <= 2 * g_again and p_mesh <= 2 * p_again):
        failed.append(f"(b) gradients {g_mesh} / parameters {p_mesh} apart, "
                      f"two plain runs {g_again} / {p_again}")
    return {"launches": dict(seen), "failed": failed,
            "step_ms": {"nccl": mesh[1], "plain": plain[1],
                        "plain again": again[1]}}


def _parallel_rank(rank, world, port, spec_path, out_path):
    """A spawned rank of phase 13: joins the world on cuda:0 (gloo, or NCCL
    for a world of one), runs its parts and writes its report."""
    import os
    import torch.distributed as dist
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vae_teb_tpu_torch.parallel import init_distributed
    spec = torch.load(spec_path, weights_only=False)
    device = torch.device(spec["device"])
    if device.type == "cpu":
        torch.set_num_threads(2)
    info = init_distributed(backend=spec["backend"], device=device)
    report = {}
    for part in spec["parts"]:
        if part == "dp":
            report[part] = _mesh_part(spec, info, device, 1, PARALLEL_STEPS,
                                      "(a) 2-rank data parallel")
        elif part == "hybrid":
            report[part] = _mesh_part(spec, info, device, 2, HYBRID_STEPS,
                                      "(c) 1 x 2 hybrid")
        else:
            report[part] = _nccl_part(spec, info, device)
    dist.destroy_process_group()
    with open(f"{out_path}.rank{rank}.json", "w") as f:
        json.dump(report, f)


def _spawn_world(world, spec, tmp, name):
    """Run `world` ranks of _parallel_rank; every rank must exit 0 within
    PARALLEL_TIMEOUT_S. Returns their reports."""
    import os
    import socket
    import torch.multiprocessing as mp
    spec_path = os.path.join(tmp, f"{name}.pt")
    torch.save(spec, spec_path)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = os.path.join(tmp, name)
    ctx = mp.start_processes(_parallel_rank,
                             args=(world, port, spec_path, out),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.perf_counter() + PARALLEL_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                raise TimeoutError(f"phase 13 {name}: ranks still running "
                                   f"after {PARALLEL_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    reports = []
    for r in range(world):
        with open(f"{out}.rank{r}.json") as f:
            reports.append(json.load(f))
    return reports


def _cli_phase(device, frontend, gen, tmp):
    """(d) `cli train --multihost` as a one-rank torchrun world on NCCL: a
    packed store of CLI_WINDOWS windows through the frontend (model layout,
    as phase 9's), a YAML config, one epoch; a checkpoint must exist."""
    import os
    from vae_teb_tpu_torch.data import PackedWindowStore
    from vae_teb_tpu_torch.train import (Checkpointer, DatasetConfig,
                                         ModelConfig, RunConfig, TrainerConfig,
                                         save_config)
    parts = {k: [] for k in ("fhr_st", "fhr_ph", "fhr_up_ph", "fhr")}
    for _ in range(CLI_WINDOWS // 32):
        x = torch.randn((2, 32, N), generator=gen, device=device)
        coeffs = frontend(x[0], x[1])
        for k, c in zip(("fhr_st", "fhr_ph", "fhr_up_ph"), coeffs):
            parts[k].append(c.cpu().numpy())
        trim = (N - 16 * coeffs[0].shape[1]) // 2
        parts["fhr"].append(x[0, :, trim:N - trim].cpu().numpy())
    arrays = {k: np.ascontiguousarray(np.concatenate(v))
              for k, v in parts.items()}
    store = _Windows(arrays)
    store.raw_layout = False
    PackedWindowStore.build(store, os.path.join(tmp, "cli_train"))
    cfg = RunConfig(
        tag="multihost", out_dir_base=os.path.join(tmp, "runs"),
        model=ModelConfig(input_channels=arrays["fhr_up_ph"].shape[2],
                          n_scattering=arrays["fhr_st"].shape[2],
                          n_phase=arrays["fhr_ph"].shape[2]),
        trainer=TrainerConfig(epochs=1, seed=INIT_SEED),
        dataset=DatasetConfig(train_paths=[os.path.join(tmp, "cli_train")],
                              batch_size=32))
    path = os.path.join(tmp, "multihost.yaml")
    save_config(cfg, path)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", "-m", "vae_teb_tpu_torch.cli", "train",
         "--config", path, "--multihost", "--plot-every", "0",
         *(["--device", "cpu"] if device.type == "cpu" else [])],
        cwd=root, capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=root))
    run_dir = cfg.run_dir(create=False)
    ckpt = Checkpointer(os.path.join(run_dir, "model_checkpoints"))
    log_path = os.path.join(run_dir, "train_results", "train.log")
    lines = (open(log_path).read().splitlines()
             if os.path.exists(log_path) else [])
    log(f"(d) cli train --multihost, one-rank torchrun world on NCCL: exit "
        f"{proc.returncode} in {time.perf_counter() - t0:.1f} s; latest "
        f"checkpoint {ckpt.latest()}; log: "
        + " | ".join(line.split(" - ", 1)[-1] for line in lines
                     if "epoch 0" in line or "global batch" in line))
    if proc.returncode != 0 or ckpt.latest() is None:
        raise AssertionError(f"(d) cli train --multihost failed (exit "
                             f"{proc.returncode}):\n{proc.stderr[-3000:]}")


def parallel_phase(device, model=None, tp_min_dim=2048):
    """Phase 13: (a) two ranks sharing cuda:0 over gloo, data parallel at a
    global B=64 for PARALLEL_STEPS steps, each step against the plain
    Trainer from the run's state before it; (b) a one-rank NCCL world
    through the data-parallel path against the plain Trainer; (c) two
    ranks as 1 x 2 (the four 4800x4800 head kernels sharded) for
    HYBRID_STEPS steps, checked as (a), with each rank's parameter and
    moment bytes; (d) `cli train --multihost` under torchrun. `model`:
    SeqVaeTeb's arguments (full width when None), `tp_min_dim` the
    TrainerConfig's (the production 2048 shards the heads). Returns each rank's
    kernel launches of (a) and (c)."""
    import os
    import tempfile
    from vae_teb_tpu_torch import (SeqVaeTeb, Trainer, TrainerConfig,
                                   WindowFrontend, init_parameters,
                                   production_frontend)
    from vae_teb_tpu_torch.kernels import build
    model = model or {}
    built = (sorted(os.listdir(build.BUILD_DIR))
             if os.path.isdir(build.BUILD_DIR) else [])
    frontend = WindowFrontend(production_frontend(device))
    gen = torch.Generator(device=device).manual_seed(13)
    batches, eps = [], []
    for _ in range(PARALLEL_STEPS):
        x = torch.randn((2, PARALLEL_BATCH, N), generator=gen, device=device)
        coeffs = frontend(x[0], x[1])
        seq = coeffs[0].shape[1]
        batches.append({k: c.cpu() for k, c in zip(
            ("fhr_st", "fhr_ph", "fhr_up_ph"), coeffs)})
        batches[-1]["fhr"] = torch.randn((PARALLEL_BATCH, 16 * seq),
                                         generator=gen, device=device).cpu()
        eps.append(torch.randn((PARALLEL_BATCH, seq, 32), generator=gen,
                               device=device).cpu())
    beta = 1e-5
    spec = {"batches": batches, "eps": eps, "beta": beta,
            "model": model, "device": str(device), "tp_min_dim": tp_min_dim,
            "card": card() if device.type == "cuda" else "cpu"}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_scratch")
    os.makedirs(root, exist_ok=True)
    failed, launches = [], {}
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        t0 = time.perf_counter()
        gloo = _spawn_world(2, dict(spec, backend="gloo",
                                    parts=["dp", "hybrid"]), tmp, "gloo")
        t1 = time.perf_counter()
        nccl = _spawn_world(1, dict(spec, backend="nccl" if device.type
                                    == "cuda" else "gloo", parts=["nccl"]),
                            tmp, "nccl")
        t2 = time.perf_counter()
        log(f"phase 13 worlds: 2 gloo ranks ((a), (c)) {t1 - t0:.1f} s, one "
            f"NCCL rank ((b)) {t2 - t1:.1f} s, start-up and kernel loads "
            f"included")
        for part, steps in (("dp", PARALLEL_STEPS), ("hybrid", HYBRID_STEPS)):
            for r, rep in enumerate(gloo):
                got = rep[part]
                failed += got["failed"]
                launches[f"{part} rank{r}"] = got["launches"]
                log(f"{part} rank {r} ({got['mesh']}): step ms {got['step_ms']!r}"
                    f" (two ranks on one card over gloo's host staging: no "
                    f"measure of multi-card speed); parameter bytes "
                    f"{got['param_bytes']}, Adam moment bytes "
                    f"{got['moment_bytes']}; kernel launches "
                    f"{got['launches']}; metrics " + "; ".join(
                        f"step {i + 1} total_loss {m['total_loss']!r} "
                        f"grad_norm {m['grad_norm']!r}"
                        for i, m in enumerate(got["metrics"])))
                local = PARALLEL_BATCH // (2 if part == "dp" else 1)
                want = {f"wavefront_fwd_res_f32 B={local}": steps,
                        f"wavefront_bwd_f32 B={local}": steps}
                if got["launches"] != want:
                    failed.append(f"{part} rank {r} launched "
                                  f"{got['launches']}, expected {want}")
            if gloo[0][part]["metrics"] != gloo[1][part]["metrics"]:
                failed.append(f"{part}: the ranks' metrics differ")
        full = gloo[0]["dp"]["param_bytes"]
        halves = [rep["hybrid"]["param_bytes"] for rep in gloo]
        heads = 4 * (16 * seq) ** 2 * 4    # four (16 S)^2 fp32 head weights
        if any(abs(h - (full - heads // 2)) > 0 for h in halves):
            failed.append(f"(c) a rank holds {halves} parameter bytes, "
                          f"expected {full - heads // 2}")
        failed += nccl[0]["nccl"]["failed"]
        launches["nccl rank0"] = nccl[0]["nccl"]["launches"]
        _cli_phase(device, frontend, gen, tmp)
    if os.path.isdir(build.BUILD_DIR) and sorted(
            os.listdir(build.BUILD_DIR)) != built:
        failed.append("a rank built the kernels again")
    if failed:
        raise AssertionError("phase 13 checks failed:\n" + "\n".join(failed))
    return launches


# Phase 14: steps_per_execution on the card, the train step replayed as a
# CUDA graph (Trainer.train_multi_step).
CAPTURE_STEPS, CAPTURE_K = 8, 4   # (a): 8 steps, eager twice, then 2 x K=4
CAPTURE_TIMED = 8                 # (c): timed steps a mode
CAPTURE_PROFILED = 2              # (c): profiled steps a mode
CAPTURE_BATCHES = (32, 128)       # (c)
CAPTURE_CLI_BATCHES = 10          # (d): two groups of 4 and a tail of 2
CAPTURE_EAGER_RUNS = 5            # (a), (e), (f): eager runs, the spread
CAPTURE_ONE_STATE_RUNS = 3        # eager steps from one state, a replay's
# captured steps against eager ones, per group of entries: within this many
# times the largest relative distance between two eager runs (the eager
# steps are not deterministic on the card; see _against_eager), or within
# CAPTURE_FLOOR: a scalar that several eager runs happen to round alike can
# still differ by an ulp in another (grad_norm 7.6e-8 apart one step from
# one state, PERF.md section 6), while a fault moves the update by 1e-1 or
# more (the controls: a count frozen at the capture 0.117-0.173, a skipped
# replay 1)
CAPTURE_SPREAD = 2.0
CAPTURE_FLOOR = 1e-5
# host API calls that start device work, as torch.profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                     "cuGraphLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
                     "cuMemset")


def _snapshot(trainer, metrics):
    """The trainer's metrics ({name: (steps,)}) and its whole state, copied
    where they lie (on the card: comparing 1.1 GB of state in float64 on
    the host took most of this phase's time), one tensor a key, prefixed
    by group: metric.<name>, first.<loss> (the first step's), param.,
    stat. (BatchNorm statistics), mu. and nu. (the Adam moments, once
    made), acc. (the accumulated gradient, where one is held), and count,
    mini_step, generator and step."""
    sd = trainer.state_dict()
    opt = sd["optimizer"]
    inner = opt.get("inner", opt)
    params = dict(trainer.model.named_parameters())
    out = {f"metric.{k}": v.clone() for k, v in metrics.items()}
    # the first step's losses: one forward from one state, deterministic
    out.update({f"first.{k}": v[:1].clone() for k, v in metrics.items()
                if k != "grad_norm"})
    out.update({f"{'param' if k in params else 'stat'}.{k}":
                v.detach().clone() for k, v in sd["model"].items()})
    for group, tensors in (("mu", inner["mu"]), ("nu", inner["nu"]),
                           ("acc", opt.get("acc") or ())):
        out.update({f"{group}.{name}": t.detach().clone()
                    for name, t in zip(params, tensors) if t is not None})
    out["count"] = torch.tensor(inner["count"])
    out["mini_step"] = torch.tensor(opt.get("mini_step", 0))
    out["generator"] = sd["generator"].clone()
    out["step"] = torch.tensor(sd["step"])
    return out


def _group(key):
    return key if key.startswith("metric.") else key.split(".")[0]


# the groups of the trainer's state: each is measured against its move from
# the start state (the update), the metrics against their own size
_STATE = ("param", "stat", "mu", "nu", "acc")


def _distance(a, b, start=None, groups=None):
    """Per group of entries (`_group`; only `groups` if given), the relative
    L2 distance of snapshot a from b: ||a - b|| over b's move from `start`
    in the state's groups (an entry absent from start moved from 0), over
    ||b|| in the others."""
    num, den = Counter(), Counter()
    for k in b:
        g = _group(k)
        if groups is not None and g not in groups:
            continue
        y = b[k].double()
        x = a[k].double() if k in a else torch.zeros_like(y)   # none held
        num[g] += (x - y).square().sum().item()
        ref = (y - start[k].double() if start is not None and g in _STATE
               and k in start else y)
        den[g] += ref.square().sum().item()
    return {g: (num[g] / den[g]) ** 0.5 if den[g] else num[g] ** 0.5
            for g in den}


def _leaves(a, b, start, group, n=4):
    """The n entries of `group` that hold most of ||a - b||^2: (name, their
    share of it, their own distance over their move from start, their
    share of the group's squared move), rounded for the log."""
    d = {k: (a[k].double() - b[k].double()).square().sum().item()
         for k in b if _group(k) == group}
    w = {k: (b[k].double() - (start[k].double() if k in start else 0))
         .square().sum().item() for k in d}
    total, moved = sum(d.values()) or 1.0, sum(w.values()) or 1.0
    return [(k.split(".", 1)[1], f"{d[k] / total:.3g}",
             f"{(d[k] / w[k]) ** 0.5 if w[k] else float('inf'):.3g}",
             f"{w[k] / moved:.3g}")
            for k in sorted(d, key=d.get, reverse=True)[:n]]


def _first_step_apart(first, start, lr, label):
    """Log how far E1's and E2's parameters are apart after their first
    step: relative to that step's update, and the share of elements more
    than lr/100 and more than lr apart (an Adam step at count 1 moves each
    element by lr times the sign of its gradient)."""
    a, b = first
    n = far = flipped = 0
    num = den = 0.0
    for k in b:
        d = (a[k].double() - b[k].double()).abs()
        n += d.numel()
        far += (d > lr / 100).sum().item()
        flipped += (d > lr).sum().item()
        num += d.square().sum().item()
        den += (b[k].double() - start[f"param.{k}"].double()).square().sum(
            ).item()
    rel = (num / den) ** 0.5 if den else num ** 0.5
    log(f"{label}: E1 and E2 after the first step: parameters {rel!r} of "
        f"the update apart, {far / n!r} of the elements more than lr/100 "
        f"apart and {flipped / n!r} more than lr, of {n}")


def _eager_and_captured(fresh, batches, beta, k, label):
    """The same steps from one state CAPTURE_EAGER_RUNS times eagerly (E1,
    E2, ...) and once as groups of k through train_multi_step (C; its
    first group runs eagerly and is captured, the rest replay), and two
    controls, runs that a faulty capture would give: E1 without its last
    step (a replay skipped), and an eager run whose bias corrections stay
    at the count the graph was captured at (a count frozen on the host).
    Logs how far E1 and E2 are apart after their first step. Returns ({run:
    snapshot}, the start's snapshot, the C trainer, the kernel entries C
    launched, {control: snapshot})."""
    runs, controls, start, first = {}, {}, None, []
    for i in range(CAPTURE_EAGER_RUNS):
        t = fresh()
        if start is None:
            start = _snapshot(t, {})
        steps = []
        for j, b in enumerate(batches):
            if i == 0 and j == len(batches) - 1:
                controls["E1 without its last step"] = _snapshot(t, {})
            steps.append(t.train_step(b, beta))
            if j == 0 and i < 2:
                first.append({k: p.detach().clone()
                              for k, p in t.model.named_parameters()})
        runs[f"E{i + 1}"] = _snapshot(t, {m: torch.stack([s[m] for s in steps])
                                          for m in steps[0]})
    _first_step_apart(first, start, t.config.lr, label)
    del first
    t = fresh()
    inner = getattr(t.optimizer, "inner", t.optimizer)
    for j, b in enumerate(batches):
        if j == k:
            frozen = int(inner.count)
        if j >= k:
            inner.count.fill_(frozen)
        t.train_step(b, beta)
    controls["bias corrections at the capture's count"] = _snapshot(t, {})
    t = fresh()
    before = _entry_counts()
    groups = [t.train_multi_step(_stack(batches[i:i + k]), beta)
              for i in range(0, len(batches), k)]
    torch.cuda.synchronize()
    launched = dict(_entry_counts() - before)
    runs["C"] = _snapshot(t, {m: torch.cat([g[m] for g in groups])
                              for m in groups[0]})
    return runs, start, t, launched, controls


# entries the same on every run from one state by construction: the
# count, the micro-step, the generator state, the step and the first
# step's losses (one train-mode forward, which is deterministic; its
# backward is not)
_EXACT = ("count", "mini_step", "generator", "step", "first.")


def _against_eager(runs, label, start, controls=None):
    """C against the eager runs from `start`. The eager steps on the card
    are not deterministic (cuDNN's weight gradient and the backward of
    the reflect pad add with atomics), and a
    trajectory carries a step's difference on, so C is held to the eager
    runs' spread: bit for bit in the entries that are deterministic by
    construction (`_EXACT`), and in each group of entries (`_group`; the
    state's groups measured against their move from start) within
    CAPTURE_SPREAD times the largest distance between two eager runs, or
    CAPTURE_FLOOR where that is smaller.
    Logs how the eager runs drift apart step by step (grad_norm) and which
    leaves hold the E1-E2 distance of the parameters and first moments.
    Each control (a run a faulty capture would give) is measured against
    the same bar in the state's groups. Returns (the failures, {control:
    the groups in which it is over the bar})."""
    eager = sorted(k for k in runs if k.startswith("E"))
    e1, c = runs["E1"], runs["C"]
    exact = [k for k in e1 if k.startswith(_EXACT)]
    moved = [k for k in exact if not all(torch.equal(r[k], e1[k]) for r in
                                         [runs[e] for e in eager] + [c])]
    spread = Counter()
    for i, a in enumerate(eager):
        for b in eager[i + 1:]:
            for g, d in _distance(runs[a], runs[b], start).items():
                spread[g] = max(spread[g], d)
    bar = {g: max(CAPTURE_SPREAD * spread[g], CAPTURE_FLOOR) for g in spread}
    apart = _distance(c, e1, start)
    over = {g: (apart[g], spread[g]) for g in apart if apart[g] > bar[g]}
    norms = torch.stack([runs[e]["metric.grad_norm"].double() for e in eager])
    drift = ((norms.max(0).values - norms.min(0).values)
             / norms.min(0).values).tolist()
    log(f"{label}: {len(e1)} entries; the {len(exact)} exact ones differ "
        f"in {moved}; per group, relative distance of C from E1 against "
        f"the largest between {len(eager)} eager runs (state groups over "
        f"their move from the start): " + ", ".join(
            f"{g} {apart[g]!r} / {spread[g]!r}" for g in sorted(apart))
        + f"; total_loss E1 {e1['metric.total_loss'].tolist()}, C "
        f"{c['metric.total_loss'].tolist()}; eager grad_norm spread "
        f"(max - min) / min by step {drift}")
    for g in ("param", "mu"):
        if spread.get(g):
            log(f"{label}: E1-E2 distance in {g}, leaves holding most (name, "
                f"share of it, own distance over own move, share of the "
                f"move): {_leaves(runs['E2'], e1, start, g)}")
    failed = [f"{label}: runs differ in exact entries {moved}"] if moved else []
    if over:
        failed.append(f"{label}: C further from E1 than {CAPTURE_SPREAD} "
                      f"times the eager spread (or {CAPTURE_FLOOR}) in {over}")
    rejected = {}
    for name, x in (controls or {}).items():
        d = _distance(x, e1, start, _STATE)
        rejected[name] = sorted(g for g in d if d[g] > bar[g])
        log(f"{label}: control '{name}' from E1: " + ", ".join(
            f"{g} {d[g]!r}" for g in sorted(d))
            + f"; over the bar in {rejected[name]}")
    return failed, rejected


def _replay_against_eager(t, batch, beta, label, frozen):
    """One replay of the trainer's captured step against eager steps from
    the same state (the trainer's now): bit for bit in the exact entries,
    and each state group's update and each metric within CAPTURE_SPREAD
    times the largest distance between CAPTURE_ONE_STATE_RUNS eager steps,
    which differ only by the backward's atomics, or CAPTURE_FLOOR. Controls, steps a faulty
    capture would take, must each be over that bar in some group: no step
    (a replay skipped), and where the step updates the parameters, an
    eager step with its bias corrections at `frozen`, the count the graph
    was captured at (a count frozen on the host). The state is put back
    after. Returns the failures."""
    opt = t.optimizer
    inner = getattr(opt, "inner", opt)
    params, bufs = list(t.model.parameters()), list(t.model.buffers())
    held = (params + bufs + [v for p in params for v in inner.state[p].values()]
            + list(getattr(opt, "acc", None) or ()))
    saved = [x.detach().clone() for x in held]
    count, gen, step = inner.count.clone(), t.generator.get_state(), t.step
    micro = getattr(opt, "mini_step", None)

    def restore():
        with torch.no_grad():
            for x, v in zip(held, saved):
                x.copy_(v)
            inner.count.copy_(count)
        if micro is not None:
            opt.mini_step = micro
        t.generator.set_state(gen)
        t.step = step

    start = _snapshot(t, {})
    runs = {}
    for i in range(CAPTURE_ONE_STATE_RUNS):
        restore()
        m = t.train_step(batch, beta)
        runs[f"E{i + 1}"] = _snapshot(t, {k: v.reshape(1)
                                          for k, v in m.items()})
    restore()
    replays = sum(g.replays for g in t.graphs.values())
    runs["C"] = _snapshot(t, t.train_multi_step(_stack([batch]), beta))
    replays = sum(g.replays for g in t.graphs.values()) - replays
    controls = {"no step": start}
    if micro is None or micro == opt.every_k - 1:
        restore()
        inner.count.fill_(frozen)
        t.train_step(batch, beta)
        controls[f"bias corrections at count {frozen + 1}"] = _snapshot(t, {})
    restore()
    failed, rejected = _against_eager(runs, label, start, controls)
    failed += [f"{label}: the bar does not reject the control '{name}'"
               for name, groups in rejected.items() if not groups]
    if replays != 1:
        failed.append(f"{label}: {replays} replays, expected 1")
    return failed


def _profiled(fn, steps):
    """fn() under torch.profiler: (device busy ms a step, the device events,
    host calls that start device work, a step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vae_teb_tpu_torch.profile_train import _busy_us, _kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = _kernels(prof)
    host = sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
               and e.name.startswith(HOST_LAUNCH_CALLS))
    return _busy_us(kernels) / 1e3 / steps, kernels, host / steps


def _coefficient_batches(frontend, gen, n, b, raw_len, device):
    """n seeded batches of B raw windows through the frontend on the card,
    as train_step takes them."""
    out = []
    for _ in range(n):
        x = torch.randn((2, b, N), generator=gen, device=device)
        coeffs = frontend(x[0], x[1])
        out.append(dict(zip(("fhr_st", "fhr_ph", "fhr_up_ph"), coeffs),
                        fhr=torch.randn((b, raw_len), generator=gen,
                                        device=device)))
    return out


def _stack(batches):
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def _captured(trainers):
    """The kernel launches that the trainers' graph replays made, by entry
    point."""
    n = Counter()
    for t in trainers:
        for g in t.graphs.values():
            for (_, key), k in g.launches.items():
                if key.startswith("wavefront_"):
                    n[key] += k * g.replays
    return n


def _captured_parts(trainer, batch):
    """The step's deterministic parts, each captured alone as a CUDA graph
    and replayed from the state its eager run started from: the train-mode
    forward and the losses (the same noise from the trainer's generator),
    and the optimizer step on fixed gradients. Returns {part: the outputs,
    parameters, moments or count that differ from the eager run}."""
    from vae_teb_tpu_torch.models import compute_loss
    model, opt, gen = trainer.model, trainer.optimizer, trainer.generator
    params, bufs = list(model.parameters()), list(model.buffers())
    saved = ([p.detach().clone() for p in params], [b.clone() for b in bufs],
             [{k: v.clone() for k, v in opt.state[p].items()}
              for p in params], opt.count.clone(), gen.get_state())
    y_st, y_ph, x_ph, y_raw = (batch[k] for k in ("fhr_st", "fhr_ph",
                                                  "fhr_up_ph", "fhr"))
    g = torch.Generator(device=y_st.device).manual_seed(3)
    grads = [1e-2 * torch.randn(p.shape, generator=g, device=p.device)
             for p in params]
    for p in params:
        p.grad = None

    def restore():
        with torch.no_grad():
            for p, v in zip(params, saved[0]):
                p.copy_(v)
            for b, v in zip(bufs, saved[1]):
                b.copy_(v)
            for p, st in zip(params, saved[2]):
                for k, v in st.items():
                    opt.state[p][k].copy_(v)
            opt.count.copy_(saved[3])
        gen.set_state(saved[4])
        for p, gr in zip(params, grads):   # in place: a graph reads them
            if p.grad is None:
                p.grad = gr.clone()
            else:
                p.grad.copy_(gr)

    @torch.no_grad()
    def forward():
        out = model.train()(y_st, y_ph, x_ph, deterministic=False,
                            generator=gen)
        return dict(compute_loss(out, y_st, y_ph, y_raw, beta=trainer._beta),
                    **out)

    def optimizer():
        opt.step()
        return dict(enumerate(params), count=opt.count,
                    **{f"mu{i}": opt.state[p]["mu"]
                       for i, p in enumerate(params)})

    differ = {}
    for name, part in (("forward", forward), ("optimizer", optimizer)):
        restore()
        eager = {k: v.clone() for k, v in part().items()}
        restore()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        with torch.cuda.graph(graph):
            got = part()
        restore()
        graph.replay()
        torch.cuda.synchronize()
        differ[name] = [k for k in eager if not torch.equal(got[k], eager[k])]
    restore()
    return differ


def capture_phase(device):
    """Phase 14: `Trainer.train_multi_step` on the card. Returns the kernel
    launches that graph replays made, by entry point."""
    import copy
    from vae_teb_tpu_torch import (SeqVaeTeb, Trainer, TrainerConfig,
                                   WindowFrontend, init_parameters,
                                   production_frontend)
    failed = []
    frontend = WindowFrontend(production_frontend(device))
    gen = torch.Generator(device=device).manual_seed(14)
    log(f"capture: torch {torch.__version__}, CUDAGraph."
        f"register_generator_state "
        f"{hasattr(torch.cuda.CUDAGraph, 'register_generator_state')}; "
        f"card {card()}")
    seeded = init_parameters(SeqVaeTeb(), seed=INIT_SEED)
    raw_len = seeded.decoder.raw_len
    cfg = TrainerConfig(steps_per_execution=CAPTURE_K)
    beta = 1e-5
    trainers, captured = [], Counter()

    def drop():   # count the trainers' replayed launches, then free them
        captured.update(_captured(trainers))
        del trainers[:]
        torch.cuda.empty_cache()

    def fresh(config=cfg, model=seeded):   # the seeded state, step 0
        t = Trainer(copy.deepcopy(model), config, device)
        trainers.append(t)
        return t

    t_part = time.perf_counter()
    # (a) eight eager steps five times, then two groups of K=4 from one state
    batches = _coefficient_batches(frontend, gen, CAPTURE_STEPS, 32, raw_len,
                                   device)
    label = "capture (a) B=32 fp32"
    runs, start, t, launched, controls = _eager_and_captured(
        fresh, batches, beta, CAPTURE_K, label)
    graphs = list(t.graphs.values())
    failed += _against_eager(runs, label, start, controls)[0]
    del runs, start, controls
    log(f"capture (a): graphs {[(g.replays, dict(g.launches)) for g in graphs]}"
        f"; step {t.step}, count {int(t.optimizer.count)}")
    parts = _captured_parts(t, batches[-1])
    log(f"capture (a): the step's deterministic parts captured alone and "
        f"replayed from the eager run's state, entries that differ: {parts}")
    if any(parts.values()):
        failed.append(f"(a) captured parts differ from eager: {parts}")
    if (len(graphs) != 1 or graphs[0].replays != CAPTURE_STEPS - CAPTURE_K
            or t.step != CAPTURE_STEPS):
        failed.append(f"(a) {len(graphs)} graphs, replays "
                      f"{[g.replays for g in graphs]}, step {t.step}")
    failed += _replay_against_eager(t, batches[0], beta, "capture (a) one "
                                    "replay from C's state", CAPTURE_K)
    # (b) launches: by the counters, and in a profiler window of one replay
    want = {"wavefront_fwd_res_f32": CAPTURE_STEPS,
            "wavefront_bwd_f32": CAPTURE_STEPS}
    log(f"capture (b): kernel entries launched in C {launched} (expected "
        f"{want})")
    if launched != want:
        failed.append(f"(b) C launched {launched}, expected {want}")
    one = _stack(batches[:1])
    _, kernels, host_graph = _profiled(
        lambda: t.train_multi_step(one, beta), 1)
    seen = {key: sum(f"wavefront_{key}_kernel" in e.name for e in kernels)
            for key in ("fwd", "bwd")}
    _, eager_kernels, host_eager = _profiled(
        lambda: t.train_step(batches[0], beta), 1)
    log(f"capture (b): one replay under torch.profiler: {len(kernels)} "
        f"device events, wavefront kernels {seen} (expected one each); host "
        f"calls starting device work {host_graph!r} a captured step against "
        f"{host_eager!r} an eager step ({len(eager_kernels)} device events)")
    if seen != {"fwd": 1, "bwd": 1}:
        failed.append(f"(b) the profiler saw the wavefront kernels {seen} "
                      f"times in one replay")
    del t, graphs   # (c)'s peak memory holds (c)'s trainer alone
    drop()
    log(f"capture (a)-(b) took {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()

    # (c) ms a step, idle share and peak memory, eager against captured
    for precision in ("fp32", "bf16"):
        for b in CAPTURE_BATCHES:
            pcfg = TrainerConfig(steps_per_execution=CAPTURE_TIMED,
                                 precision=precision, moment_dtype=precision)
            if precision == "fp32":
                tr = fresh(pcfg)
            else:   # the seeded weights under the bf16 policy
                model = SeqVaeTeb(dtype=pcfg.model_dtype())
                model.load_state_dict(seeded.state_dict())
                tr = fresh(pcfg, model)
            batch = _coefficient_batches(frontend, gen, 1, b, raw_len,
                                         device)[0]
            row = {}
            tr.train_step(batch, beta)                 # warm-up
            t0 = time.perf_counter()
            tr.train_multi_step(_stack([batch]), beta)  # eager, then capture
            torch.cuda.synchronize()
            row["warm_up_and_capture_s"] = time.perf_counter() - t0
            for mode in ("eager", "captured"):
                def run(n):
                    if mode == "eager":
                        return [tr.train_step(batch, beta) for _ in range(n)]
                    return tr.train_multi_step(_stack([batch] * n), beta)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
                t0 = time.perf_counter()
                run(CAPTURE_TIMED)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / CAPTURE_TIMED
                peak = torch.cuda.max_memory_allocated(device)
                busy, events, host = _profiled(lambda: run(CAPTURE_PROFILED),
                                               CAPTURE_PROFILED)
                row[mode] = {"ms_a_step": ms, "device_busy_ms": busy,
                             "idle_share": 1 - busy / ms,
                             "device_events_a_step":
                                 len(events) / CAPTURE_PROFILED,
                             "host_launch_calls_a_step": host,
                             "peak_memory_bytes": peak}
            log(f"capture (c) {precision} B={b}: " + json.dumps(row)
                + f" ({card()})")
            if not row["captured"]["ms_a_step"] > 0:
                failed.append(f"(c) {precision} B={b}: {row}")
            del tr
            drop()

    log(f"capture (c) took {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()
    # (d) cli.run_training with steps_per_execution 4 against 1
    failed += _capture_cli(device, frontend, gen)
    log(f"capture (d) took {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()

    # (e) H=128: the grid kernels' cooperative launch inside the graph
    wide = init_parameters(SeqVaeTeb(lstm_hidden_dim=128), seed=INIT_SEED)
    wb = _coefficient_batches(frontend, gen, 4, 32, raw_len, device)
    label = "capture (e) SeqVaeTeb(lstm_hidden_dim=128) B=32 fp32"
    runs, start, t, launched, controls = _eager_and_captured(
        lambda: fresh(TrainerConfig(steps_per_execution=2), wide), wb, beta,
        2, label)
    failed += _against_eager(runs, label, start, controls)[0]
    del runs, start, controls
    replays = [g.replays for g in t.graphs.values()]
    failed += _replay_against_eager(t, wb[0], beta, label + ", one replay "
                                    "from C's state", 2)
    want = {"wavefront_grid_fwd_res_f32": 4, "wavefront_grid_bwd_f32": 4}
    log(f"capture (e): replays {replays}, grid kernel entries launched in C "
        f"{launched} (expected {want})")
    if launched != want or replays != [2]:
        failed.append(f"(e) launched {launched} (expected {want}), replays "
                      f"{replays}")
    drop()
    log(f"capture (e) took {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()

    # (f) accumulation over 2: a graph a micro-step, the micro-step moved on
    # by the trainer after each replay
    acfg = TrainerConfig(steps_per_execution=CAPTURE_K,
                         accumulate_grad_batches=2)
    label = "capture (f) accumulate_grad_batches=2, K=4, B=32 fp32"
    runs, start, t, launched, controls = _eager_and_captured(
        lambda: fresh(acfg), batches, beta, CAPTURE_K, label)
    failed += _against_eager(runs, label, start, controls)[0]
    graphs = sorted((micro, g.replays) for (_, micro), g in t.graphs.items())
    state = {k: int(runs["E1"][k]) for k in ("count", "mini_step", "step")}
    log(f"capture (f): graphs (micro-step, replays) {graphs}; E1's count, "
        f"micro-step and step {state}; kernel entries launched in C "
        f"{launched}")
    if (graphs != [(0, 2), (1, 2)]
            or state != {"count": 4, "mini_step": 0, "step": 8}):
        failed.append(f"(f) graphs {graphs}, state {state}")
    del runs, start, controls
    for micro in (0, 1):   # one replay of each micro-step's graph
        failed += _replay_against_eager(
            t, batches[micro], beta, f"capture (f) one replay of micro-step "
            f"{micro} from C's state", 2)
        t.train_step(batches[micro], beta)
    del t
    drop()
    log(f"capture (f) took {time.perf_counter() - t_part:.1f} s")
    captured.update(_CAPTURED)
    if failed:
        raise AssertionError("capture checks failed:\n" + "\n".join(failed))
    return captured


_CAPTURED = Counter()   # (d)'s replayed launches, by entry point


def _capture_cli(device, frontend, gen):
    """Phase 14 (d): `cli.run_training` on a packed store of
    CAPTURE_CLI_BATCHES batches of 32 (fp32, device normalization, two
    epochs) with steps_per_execution 4, against three runs with 1: the
    history's train metrics no further from the first K=1 run's than
    CAPTURE_SPREAD times the largest distance between two K=1 runs
    (relative, per metric and epoch). Returns the failures."""
    import os
    import tempfile
    from vae_teb_tpu_torch import Trainer
    from vae_teb_tpu_torch.cli import run_training
    from vae_teb_tpu_torch.data import PackedWindowStore
    from vae_teb_tpu_torch.train import (DatasetConfig, ModelConfig,
                                         RunConfig, TrainerConfig)
    from vae_teb_tpu_torch.utils import setup_logging
    setup_logging(capture_root=False)
    parts = {k: [] for k in ("fhr_st", "fhr_ph", "fhr_up_ph", "fhr")}
    for _ in range(CAPTURE_CLI_BATCHES):
        x = torch.randn((2, 32, N), generator=gen, device=device)
        coeffs = frontend(x[0], x[1])
        for k, c in zip(("fhr_st", "fhr_ph", "fhr_up_ph"), coeffs):
            parts[k].append(c.transpose(1, 2).cpu().numpy())
        trim = (N - 16 * coeffs[0].shape[1]) // 2
        parts["fhr"].append(x[0, :, trim:N - trim].cpu().numpy())
    arrays = {k: np.ascontiguousarray(np.concatenate(v))
              for k, v in parts.items()}
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_scratch")
    os.makedirs(root, exist_ok=True)
    histories, multi = {}, []
    step_fn = Trainer.train_multi_step

    def spy(self, stacked, beta, eps=None):
        multi.append(int(stacked["fhr"].shape[0]))
        return step_fn(self, stacked, beta, eps)

    with tempfile.TemporaryDirectory(dir=root) as tmp:
        store = os.path.join(tmp, "train")
        PackedWindowStore.build(_Windows(arrays), store)
        stats = _field_stats(arrays)
        Trainer.train_multi_step = spy
        try:
            for name, spe in (("K=1 a", 1), ("K=1 b", 1), ("K=1 c", 1),
                              ("K=4", 4)):
                cfg = RunConfig(
                    tag=f"capture{spe}{name[-1]}",
                    out_dir_base=os.path.join(tmp, "runs"),
                    model=ModelConfig(
                        input_channels=arrays["fhr_up_ph"].shape[1],
                        n_scattering=arrays["fhr_st"].shape[1],
                        n_phase=arrays["fhr_ph"].shape[1]),
                    trainer=TrainerConfig(epochs=2, seed=INIT_SEED,
                                          steps_per_execution=spe),
                    dataset=DatasetConfig(train_paths=[store], batch_size=32))
                trainer = run_training(cfg, device, normalize_stats=stats,
                                       plot_every=0)
                histories[name] = trainer.history
                _CAPTURED.update(_captured([trainer]))
                del trainer
        finally:
            Trainer.train_multi_step = step_fn
    keys = [k for k in histories["K=4"] if k.startswith("train/")]

    def distance(run, ref):   # the largest relative distance of a metric
        return max(abs(a / b - 1) for k in keys
                   for a, b in zip(histories[run][k], histories[ref][k]))

    spread = max(distance(x, y) for x, y in (("K=1 b", "K=1 a"),
                                             ("K=1 c", "K=1 a"),
                                             ("K=1 c", "K=1 b")))
    apart = distance("K=4", "K=1 a")
    log(f"capture (d) cli.run_training, {CAPTURE_CLI_BATCHES} batches of "
        f"32, 2 epochs: train_multi_step groups {multi}; train/total_loss "
        f"by epoch K=4 {histories['K=4']['train/total_loss']}, K=1 "
        f"{[histories[r]['train/total_loss'] for r in ('K=1 a', 'K=1 b', 'K=1 c')]}"
        f"; largest relative difference of a train metric: K=4 from the "
        f"first K=1 run {apart!r}, between two K=1 runs {spread!r}; win/s "
        f"by epoch K=1 "
        f"{[histories[r]['windows_per_sec'] for r in ('K=1 a', 'K=1 b', 'K=1 c')]}"
        f", K=4 "
        f"{histories['K=4']['windows_per_sec']} (K=4's first epoch holds "
        f"the eager first group and the capture)")
    failed = []
    if multi != [4, 4, 2] * 2:
        failed.append(f"(d) train_multi_step groups {multi}, expected "
                      f"[4, 4, 2] an epoch")
    if apart > CAPTURE_SPREAD * spread:
        failed.append(f"(d) K=4's history {apart!r} from K=1's, over "
                      f"{CAPTURE_SPREAD} times K=1's own spread ({spread!r})")
    return failed


# Phase 15: the LSTM shapes the kernels take through zero padding (H not a
# multiple of 8) and depth groups (stacks too wide for one launch)
COVERAGE_PADDED = (5, 60, 100)   # hidden sizes padded to 8, 64, 104
COVERAGE_WIDE = 512              # two 4-layer streams: 8 units too many
# (d): units over a CTA's shared memory, on the streamed grid kernels:
# SeqVaeTeb(lstm_hidden_dim=1024) in fp32 and 1536 in bf16, and the kernels
# alone at (depths, H, dtype): one unit, a group of one layer of both
# streams, a group of two layers of both with their two feed blocks
COVERAGE_STREAMED = ((1024, torch.float32), (1536, torch.bfloat16))
COVERAGE_STREAMED_KERNELS = (((1,), 1024, torch.float32),
                             ((1, 1), 1024, torch.float32),
                             ((2, 2), 1024, torch.float32),
                             ((1, 1), 1536, torch.bfloat16))
COVERAGE_STREAMED_PLAIN_RUNS = 3   # plain-version timings of (d)
# (d)'s plans timed against a resident share of 0 and clusters of 2
COVERAGE_STREAM_PLANS = (((1, 1), 1024, torch.float32),
                         ((1, 1), 1536, torch.bfloat16))
COVERAGE_BATCH = 32
# phase 15's timed runs (median of 5, after a warm-up): it times 8 shapes
# of kernels and cuDNN (bf16 cuDNN 20-63 ms a call) and the encoder LSTMs
COVERAGE_TIMED_RUNS = 5
# A bf16 model run held to another bf16 run (kernels against the plain
# recurrence; chained against one group) within this many times the plain
# bf16 model's own distance from the plain fp32 model, max-abs over max of
# the worst output: the decoder heads amplify a bf16 rounding anywhere
# upstream (PERF.md section 6: on an H100 the bf16 model is 0.86 of max
# from fp32 at lstm_hidden_dim=512, B=32, where phase 6's 0.1 holds at
# 64), while a wrong layer or state moves the encoders' outputs by O(1)
BF16_POLICY_RATIO = 1.5


def _one_group(depths, h, dtype, device):
    """A planner that puts every layer of every stream in one launch."""
    return (tuple((s, 0, d) for s, d in enumerate(depths)),)


def _at_width(seeded, hidden, dtype=None):
    """SeqVaeTeb(lstm_hidden_dim=hidden, dtype=dtype) holding `seeded`'s
    conditional encoder and decoder, its encoders (whose widths follow the
    LSTM's) initialized from INIT_SEED."""
    from vae_teb_tpu_torch import SeqVaeTeb, init_parameters
    m = SeqVaeTeb(lstm_hidden_dim=hidden, dtype=dtype)
    if hidden == seeded.source_encoder.lstm.hidden_size:
        m.load_state_dict(seeded.state_dict())
        return m
    for name in ("source_encoder", "target_encoder"):
        init_parameters(getattr(m, name), seed=INIT_SEED)
    for name in ("conditional_encoder", "decoder"):
        getattr(m, name).load_state_dict(getattr(seeded, name).state_dict())
    return m


def _model_runs(device, model, frontend, batch, eps, beta, label, failed,
                fp32_plain=None, both_ways=False):
    """One serving forward and one train step of `model` (copied for each
    run) through the kernels, with their launches by entry
    point and the checks: launches equal to the depth groups (one serving
    forward; one residual forward and one reverse a step), finite outputs,
    the serving forward against the plain recurrence on the card in the
    same groups (fp32: phase 4's bar; bf16: within BF16_POLICY_RATIO times
    the plain bf16 model's distance from the plain fp32 model's outputs,
    `fp32_plain`), and the step's gradients against the plain reverse
    wavefront behind one forward (phase 5's and 7's bars). With
    `both_ways`, also a step through the plain recurrence both ways, whose
    forward differs by rounding (reported, not held: at B=32 ReLU inputs
    within rounding of 0 move it by a configuration's own amount, phase
    5). Returns (the groups, {entry: launches} of the serving forward and
    the step, the plain serving outputs, the gradients by run)."""
    import copy
    from vae_teb_tpu_torch import InferenceServer, Trainer, TrainerConfig
    from vae_teb_tpu_torch.kernels import (wavefront, wavefront_bwd,
                                           wavefront_bwd_plain,
                                           wavefront_fwd_plain)
    from vae_teb_tpu_torch.models.blocks import padded_width
    dtype = model.dtype or torch.float32
    fp32 = dtype == torch.float32
    kind = "f32" if fp32 else "bf16"
    lstm = model.source_encoder.lstm
    hp = padded_width(lstm.hidden_size)
    groups = wavefront.wavefront_groups((lstm.num_layers,) * 2, hp, dtype,
                                        device)
    # each group's route: the grid kernels where the cluster plan refuses,
    # their streamed mode where no resident grid plan fits
    plans = {g: wavefront._launch_plan(
        COVERAGE_BATCH, sum(l1 - l0 for _, l0, l1 in g), hp, dtype,
        grid_resident=wavefront._card_grid_resident(device, dtype),
        stream_resident=wavefront._card_grid_resident(device, dtype,
                                                      stream=True))
        for g in groups}
    plan = {g: p.kind for g, p in plans.items()}
    entry = lambda route, what: {
        "cluster": f"wavefront_{what}_{kind}",
        "grid": f"wavefront_grid_{what}_{kind}",
        "stream": f"wavefront_grid_{what}_stream_{kind}"}[route]
    n = Counter(plan[g] for g in groups)
    log(f"{label}: the card's plans {sorted(set(plans.values()))}")
    coeffs = [batch[k] for k in ("fhr_st", "fhr_ph", "fhr_up_ph")]
    server = InferenceServer(copy.deepcopy(model), frontend, device)
    out, served = _launched(lambda: server.infer_coefficients(*coeffs))
    want = {entry(r, "fwd"): c for r, c in n.items()}
    server.model.recurrence = wavefront_fwd_plain
    plain = server.infer_coefficients(*coeffs)
    serve_err, serve_key = _rel_outputs(out, plain)
    if fp32:
        serve_bar, policy = SERVE_REL_TOL, ""
    else:
        own, own_key = _rel_outputs(plain, fp32_plain)
        serve_bar = BF16_POLICY_RATIO * own
        policy = (f"; the plain bf16 model against the plain fp32 model "
                  f"{own!r} ({own_key})")
    finite = all(torch.isfinite(v).all().item() for v in out.values())
    del server
    cfg = TrainerConfig(precision="fp32" if fp32 else "bf16",
                        moment_dtype="fp32" if fp32 else "bf16")
    module = sys.modules["vae_teb_tpu_torch.kernels.wavefront"]
    grads, stepped = {}, {}
    runs = ["kernels", "plain backward"] + (["plain recurrence"]
                                            if both_ways else [])
    for name in runs:
        m = copy.deepcopy(model)
        if name == "plain recurrence":
            m.recurrence = wavefront_fwd_plain
        if name == "plain backward":
            module.wavefront_bwd = wavefront_bwd_plain
        try:
            metrics, launched = _launched(lambda: Trainer(m, cfg, device)
                                          .train_step(batch, beta, eps=eps))
        finally:
            module.wavefront_bwd = wavefront_bwd
        if name == "kernels":
            stepped = launched
        grads[name] = {k: p.grad for k, p in m.named_parameters()}
        finite = finite and all(torch.isfinite(v).all().item()
                                for v in metrics.values())
        del m
    step_want = {entry(r, "fwd_res"): c for r, c in n.items()}
    step_want.update({entry(r, "bwd"): c for r, c in n.items()})
    reports = {r: grad_report(grads["kernels"], grads[r]) for r in runs[1:]}
    bar = (GRAD_REL_TOL, GRAD_REL_TOL) if fp32 else (BF16_GRAD_REL_TOL,
                                                     BF16_GRAD_L2_TOL)
    log(f"{label}: depth groups {groups} ({[plan[g] for g in groups]}); "
        f"serving forward launched {served} (expected {want}), against the "
        f"plain recurrence max-abs/max {serve_err!r} ({serve_key}; bar "
        f"{serve_bar!r}){policy}; train step launched {stepped} (expected "
        f"{step_want}), gradients " + ", ".join(
            f"against the {r}: worst leaf {w!r} ({leaf}), rel-L2 {l2!r}"
            for r, (w, leaf, l2) in reports.items())
        + f" (bars {bar} against the plain backward); finite {finite}")
    if served != want or stepped != step_want or not finite:
        failed.append(f"{label}: launches {served}, {stepped} (expected "
                      f"{want}, {step_want}), finite {finite}")
    if not serve_err <= serve_bar:
        failed.append(f"{label}: serving kernels vs plain {serve_err} "
                      f"({serve_key}), bar {serve_bar}")
    w, leaf, l2 = reports["plain backward"]
    if not (w <= bar[0] and l2 <= bar[1]):
        failed.append(f"{label}: gradients against the plain backward: {w} "
                      f"({leaf}), rel-L2 {l2}")
    return groups, Counter(served) + Counter(stepped), plain, grads


def _rel_outputs(got, want):
    """max over OUT_KEYS of max-abs(got - want) / max|want|, and its key."""
    rel = {k: ((got[k].float() - want[k].float()).abs().max()
               / want[k].float().abs().max().clamp_min(1e-30)).item()
           for k in OUT_KEYS}
    key = max(rel, key=rel.get)
    return rel[key], key


def _hoisting(device, model, frontend, batch, eps, beta, plain, grads,
              fp32_plain, label, failed):
    """The plain recurrence on the card in one launch's group against the
    same chained (`plain` serving outputs, `grads` of the step through the
    plain recurrence, fp32 only): what hoisting a group's input projection
    moves. fp32: the serving outputs within phase 4's bar, the gradients
    within phase 5's bars for forwards that differ by rounding. bf16 (whose
    hoisted projection is rounded to bf16 before the recurrent product is
    added): the chained run's distance from the fp32 model's chained run
    (`fp32_plain`) within BF16_POLICY_RATIO times the one-group run's,
    the bf16 policy's own distance."""
    import copy
    from vae_teb_tpu_torch import InferenceServer, Trainer, TrainerConfig
    from vae_teb_tpu_torch.kernels import wavefront, wavefront_fwd_plain
    fp32 = (model.dtype or torch.float32) == torch.float32
    coeffs = [batch[k] for k in ("fhr_st", "fhr_ph", "fhr_up_ph")]
    planner = wavefront.wavefront_groups
    wavefront.wavefront_groups = _one_group
    try:
        server = InferenceServer(copy.deepcopy(model), frontend, device)
        server.model.recurrence = wavefront_fwd_plain
        one = server.infer_coefficients(*coeffs)
        del server
        fwd, key = _rel_outputs(plain, one)
        report = ""
        if fp32:
            m = copy.deepcopy(model)
            m.recurrence = wavefront_fwd_plain
            Trainer(m, TrainerConfig(), device).train_step(batch, beta,
                                                            eps=eps)
            w, leaf, l2 = grad_report(grads["plain recurrence"], {
                k: p.grad for k, p in m.named_parameters()})
            del m
            report = (f"; step gradients worst leaf {w!r} ({leaf}), rel-L2 "
                      f"{l2!r} (bars {KINK_REL_TOL}, {KINK_L2_TOL})")
            if not (w <= KINK_REL_TOL and l2 <= KINK_L2_TOL):
                failed.append(f"{label}: hoisting moves the gradients {w} "
                              f"({leaf}), rel-L2 {l2}")
        else:
            chained, c_key = _rel_outputs(plain, fp32_plain)
            single, s_key = _rel_outputs(one, fp32_plain)
            report = (f"; against the fp32 model chained: chained "
                      f"{chained!r} ({c_key}), one group {single!r} "
                      f"({s_key}) (bar {BF16_POLICY_RATIO} times it)")
            if not chained <= BF16_POLICY_RATIO * single:
                failed.append(f"{label}: the chained bf16 model is "
                              f"{chained} ({c_key}) from fp32, in one group "
                              f"{single} ({s_key})")
    finally:
        wavefront.wavefront_groups = planner
    log(f"{label}: the plain recurrence chained against one group: serving "
        f"outputs max-abs/max {fwd!r} ({key}){report}")
    if fp32 and not fwd <= SERVE_REL_TOL:
        failed.append(f"{label}: hoisting moves the serving outputs {fwd} "
                      f"({key})")


def _lstm_times(device, model, batch, gen, label):
    """The model's two encoder LSTMs alone, as the model runs them
    (run_lstm_streams on the prepared streams: packing, hoisted
    projections, one launch a group) against cuDNN's LSTM computing the
    same stack (one torch.nn.LSTM(in, H, layers) per stream, the model's
    weights, batch first): the serving forward, and forward plus backward
    of a loss on ys and the final states (the weights' gradients
    included). CUDA-event ms, median of COVERAGE_TIMED_RUNS; cuDNN's
    outputs against ours (held at
    LIBRARY_REL_TOL in fp32 by the caller); ours against the plain
    recurrence in the same groups at phase 3's bars. Returns ({"fwd": (ms,
    cudnn_ms), "train": (ms, cudnn_ms)}, cuDNN's distance, whether the
    plain recurrence is within its bar)."""
    from vae_teb_tpu_torch.kernels import (wavefront_fwd_plain,
                                           wavefront_recurrence)
    from vae_teb_tpu_torch.models import run_lstm_streams
    dtype = model.dtype or torch.float32
    se, te = model.source_encoder, model.target_encoder
    model.eval()   # the LSTMs' inputs, its running statistics untouched
    with torch.no_grad():
        xs = (se.pre_lstm(batch["fhr_up_ph"]),
              te.pre_lstm(batch["fhr_st"], batch["fhr_ph"]))
    lstms = (se.lstm, te.lstm)
    cudnn = []
    for lstm, x in zip(lstms, xs):
        H, L = lstm.hidden_size, lstm.num_layers
        ref = torch.nn.LSTM(x.shape[-1], H, L, batch_first=True).to(
            device, dtype)
        with torch.no_grad():
            for l in range(L):
                p = lambda name: getattr(ref, f"{name}_l{l}")
                p("weight_ih").copy_(getattr(lstm, f"w_ih_{l}").t())
                p("weight_hh").copy_(getattr(lstm, f"w_hh_{l}").t())
                p("bias_ih").copy_(getattr(lstm, f"bias_{l}"))
                p("bias_hh").zero_()
        ref.flatten_parameters()
        cudnn.append(ref)
    cots = None

    def ours(grad, recurrence=wavefront_recurrence):
        with torch.set_grad_enabled(grad):
            outs = run_lstm_streams([l(x) for l, x in zip(lstms, xs)],
                                    recurrence)
        return [(y, h, c) for y, (h, c) in outs]

    def theirs(grad):
        with torch.set_grad_enabled(grad):
            return [(y, h, c) for y, (h, c) in (r(x.to(dtype)) for r, x in
                                                zip(cudnn, xs))]

    def loss(outs):
        return sum((o.float() * w).sum() for os_, ws in zip(outs, cots)
                   for o, w in zip(os_, ws))
    got, lib = ours(False), theirs(False)
    plain = max((a.float() - b.float()).abs().max().item() for os_, ps in zip(
        got, ours(False, wavefront_fwd_plain)) for a, b in zip(os_, ps))
    plain_tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    cots = [[torch.randn(o.shape, generator=gen, device=device) for o in os_]
            for os_ in got]
    err = max(((a.float() - b.float()).abs().max()
               / b.float().abs().max().clamp_min(1e-30)).item()
              for os_, ls in zip(got, lib) for a, b in zip(os_, ls))
    timed = lambda fn: cuda_time_ms(fn, COVERAGE_TIMED_RUNS)
    times = {"fwd": (timed(lambda: ours(False)), timed(lambda: theirs(False))),
             "train": (timed(lambda: loss(ours(True)).backward()),
                       timed(lambda: loss(theirs(True)).backward()))}
    log(f"{label}: the encoder LSTMs alone, B={COVERAGE_BATCH}: serving "
        f"forward {times['fwd'][0]!r} ms, cuDNN {times['fwd'][1]!r} ms; "
        f"forward and backward {times['train'][0]!r} ms, cuDNN "
        f"{times['train'][1]!r} ms; cuDNN's outputs against ours "
        f"max-abs/max {err!r} (bar {LIBRARY_REL_TOL[dtype]}); ours against "
        f"the plain recurrence in the same groups max-abs {plain!r} (bar "
        f"{plain_tol}) ({card()})")
    return times, err, plain <= plain_tol


def _stream_traffic(plan, depths, H, item, fwd):
    """What a streamed launch of `plan` over streams of `depths` layers of
    H moves, forward or reverse: (the resident share of its weight bytes,
    the distinct (chunks streamed, chunks) of a CTA's step, the weight
    bytes a step streams from L2 and the row bytes a step reads from L2,
    over all CTAs). A forward CTA's step holds 1 stage of ceil(H / kc)
    chunks, 2 for a unit with a feed block; a reverse CTA's 4, 8 for a
    unit feeding the one above; each CTA keeps min(kr, chunks) resident
    and reads 1/CS of every chunk's rows."""
    kc = plan.fwd_chunk if fwd else plan.bwd_chunk
    kr = plan.fwd_resident if fwd else plan.bwd_resident
    nc, per_unit = -(-H // kc), -(-H // plan.cols)
    tile = (4 if fwd else 1) * plan.cols * kc * item
    rows = -(-plan.rows // (8 if fwd else 16)) * (8 if fwd else 16)
    chunks = [nc * ((2 if l else 1) if fwd else (8 if l + 1 < d else 4))
              for d in depths for l in range(d)]
    streamed = [max(0, c - kr) for c in chunks]
    return (1 - sum(streamed) / sum(chunks), sorted(set(zip(streamed, chunks))),
            per_unit * sum(streamed) * tile,
            per_unit * sum(chunks) * rows * kc * item // plan.cluster)


def _ablated_kernels():
    """The grid kernels built again with WAVEFRONT_STREAM_NO_PRODUCT (the
    streamed mode's k-loop without its products: the copies, hand-offs
    and cells alone) into libraries of their own beside the package's
    builds, one nvcc each, in parallel: {source: library}."""
    import ctypes
    import hashlib
    import os
    from concurrent.futures import ThreadPoolExecutor
    from vae_teb_tpu_torch.kernels import build
    flags = (*build.NVCC_FLAGS, "-DWAVEFRONT_STREAM_NO_PRODUCT")

    def one(src):
        digest = hashlib.sha256(" ".join(flags).encode())
        for name in [src] + sorted(n for n in os.listdir(build.KERNEL_DIR)
                                   if n.endswith(".cuh")):
            with open(os.path.join(build.KERNEL_DIR, name), "rb") as f:
                digest.update(f.read())
        path = os.path.join(build.BUILD_DIR, f"lib{src[:-3]}-no-product-"
                            f"{digest.hexdigest()[:16]}.so")
        if not os.path.exists(path):
            os.makedirs(build.BUILD_DIR, exist_ok=True)
            subprocess.run([build._nvcc(), *flags, "-o", path,
                            os.path.join(build.KERNEL_DIR, src)], check=True,
                           capture_output=True)
        return ctypes.CDLL(path)
    sources = ("wavefront_grid_fwd.cu", "wavefront_grid_bwd.cu")
    with ThreadPoolExecutor(max_workers=2) as pool:
        return dict(zip(sources, pool.map(one, sources)))


def _l2_floor(device, shapes):
    """(d)'s L2 floor: each streamed entry at each of `shapes` (depths, H,
    dtype; B=32, K=303) timed (CUDA events, median of COVERAGE_TIMED_RUNS)
    with its products removed (`_ablated_kernels`, swapped in for the
    timing only), so that what is left is what the design's copies and
    hand-offs take: {(kind, depths, H, dtype): ms}. The outputs are not
    the function's and are not checked."""
    from vae_teb_tpu_torch.kernels import (build, wavefront_bwd,
                                           wavefront_fwd)
    gen = torch.Generator().manual_seed(14)
    runs = {}
    for depths, h, dtype in shapes:
        S = 303 - max(depths) + 1
        args = recurrence_inputs(gen, COVERAGE_BATCH, S, h, depths, dtype,
                                 device)
        W, _, xs, _, c0, lvec = args
        _, _, _, gates, c_seq = wavefront_fwd(*args, S, with_residuals=True)
        rnd = lambda *shape: (torch.randn(shape, generator=gen) * 0.1).to(
            device=device, dtype=dtype)
        UH = c0.shape[1]
        bargs = (W, gates, c_seq, torch.cat([c0[None], c_seq[:-1]]),
                 rnd(303, COVERAGE_BATCH, UH), rnd(COVERAGE_BATCH, UH),
                 rnd(COVERAGE_BATCH, UH), lvec)
        runs[(depths, h, dtype)] = {
            "fwd": lambda a=args, s=S: wavefront_fwd(*a, s),
            "fwd_res": lambda a=args, s=S: wavefront_fwd(*a, s,
                                                         with_residuals=True),
            "bwd": lambda b=bargs, s=S: wavefront_bwd(*b, s)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ablated = _ablated_kernels()
    log(f"coverage (d) L2 floor: built the grid kernels without the streamed "
        f"products in {time.perf_counter() - t0:.1f} s")
    saved = dict(build._loaded)
    out = {}
    try:
        build._loaded.update(ablated)
        for (depths, h, dtype), fns in runs.items():
            for kind, fn in fns.items():
                out[(kind, depths, h, dtype)] = cuda_time_ms(
                    fn, COVERAGE_TIMED_RUNS)
    finally:
        build._loaded.clear()
        build._loaded.update(saved)
    return out


def _stream_plans(device, failed):
    """(d): the streamed plan the card chose (B=32, K=303) at each of
    COVERAGE_STREAM_PLANS against the plans it passed over, forced for the
    call: no resident share (`_stream_ring` answering 0 resident chunks),
    and clusters of 2 (the residency answering 0 at any other (N, CS))
    where the plan took another cluster size. CUDA-event ms of the serving
    forward and the reverse (median of COVERAGE_TIMED_RUNS), each plan's
    outputs held to the plain versions at phase 3's bars. Returns
    {(depths, H, dtype, name): (plan, fwd_ms, bwd_ms)}."""
    from vae_teb_tpu_torch.kernels import (wavefront, wavefront_bwd,
                                           wavefront_bwd_plain, wavefront_fwd,
                                           wavefront_fwd_plain)
    gen = torch.Generator().manual_seed(13)
    out = {}
    for depths, H, dtype in COVERAGE_STREAM_PLANS:
        fp32 = dtype == torch.float32
        tol, btol = (FP32_TOL, BWD_FP32_TOL) if fp32 else (BF16_TOL,
                                                           BWD_BF16_TOL)
        S = 303 - max(depths) + 1
        args = recurrence_inputs(gen, COVERAGE_BATCH, S, H, depths, dtype,
                                 device)
        W, _, xs, _, c0, lvec = args
        _, _, _, gates, c_seq = wavefront_fwd_plain(*args, S,
                                                    with_residuals=True)
        UH = c0.shape[1]
        rnd = lambda *shape: torch.randn(shape, generator=gen).to(
            device=device, dtype=dtype)
        bargs = (W, gates, c_seq, torch.cat([c0[None], c_seq[:-1]]),
                 rnd(303, COVERAGE_BATCH, UH), rnd(COVERAGE_BATCH, UH),
                 rnd(COVERAGE_BATCH, UH), lvec)
        want_f, want_b = wavefront_fwd_plain(*args, S), wavefront_bwd_plain(
            *bargs, S)
        chosen = wavefront._check("plan", args[:5], lvec, xs)
        resident, ring = wavefront._card_grid_resident, wavefront._stream_ring
        none = lambda *a: (lambda r: r and r[:-1] + (0,))(ring(*a))

        def two(dev, dt, stream=False):
            held = resident(dev, dt, stream)
            return lambda N, CS, f, b: (held(N, CS, f, b) if not stream or (
                N, CS) == (chosen.cols, 2) else 0)
        variants = [("the plan", resident, ring),
                    ("no resident share", resident, none)]
        if chosen.cluster != 2:
            variants.append(("clusters of 2", two, ring))
        for name, res, rng in variants:
            wavefront._card_grid_resident, wavefront._stream_ring = res, rng
            try:
                plan = wavefront._check("plan", args[:5], lvec, xs)
                got_f, got_b = wavefront_fwd(*args, S), wavefront_bwd(*bargs,
                                                                      S)
                torch.cuda.synchronize()
                ef = max((g.float() - w.float()).abs().max().item()
                         for g, w in zip(got_f, want_f))
                eb = max((g.float() - w.float()).abs().max().item()
                         / w.float().abs().max().item()
                         for g, w in zip(got_b, want_b))
                fms = cuda_time_ms(lambda: wavefront_fwd(*args, S),
                                   COVERAGE_TIMED_RUNS)
                bms = cuda_time_ms(lambda: wavefront_bwd(*bargs, S),
                                   COVERAGE_TIMED_RUNS)
            finally:
                wavefront._card_grid_resident = resident
                wavefront._stream_ring = ring
            label = (f"coverage (d) plans, {'+'.join(map(str, depths))} "
                     f"layers H={H} {str(dtype)[6:]}, B={COVERAGE_BATCH}, "
                     f"K=303, {name}")
            log(f"{label}: N={plan.cols}, clusters of {plan.cluster}, weight "
                f"chunks {plan.fwd_chunk} / {plan.bwd_chunk} depths, rows "
                f"chunks {plan.fwd_row_chunk} / {plan.bwd_row_chunk} depths, "
                f"rings of {plan.fwd_bufs} / {plan.bwd_bufs} slots, "
                f"{plan.fwd_resident} / {plan.bwd_resident} resident "
                f"chunks: forward {fms!r} ms (max-abs {ef!r}), reverse "
                f"{bms!r} ms (of max {eb!r}) ({card()})")
            if not (ef <= tol and eb <= btol):
                failed.append(f"(d) {label}: {ef}, {eb} against the plain "
                              f"versions")
            out[(depths, H, dtype, name)] = (plan, fms, bms)
    return out


def _captured_step(device, model, batch, beta, label, launches, main_path,
                   failed):
    """A train step of `model` captured (steps_per_execution 2: two eager
    steps, then the capture) and one replay from that run's state against
    three eager steps (phase 14's bar and controls); the replay must launch
    what the eager step launched (`launches`: the residual forward and
    reverse entries of `_model_runs`). Adds the launches to `main_path`;
    returns the replays' launches by entry point."""
    import copy
    from vae_teb_tpu_torch import Trainer, TrainerConfig
    t = Trainer(copy.deepcopy(model), TrainerConfig(steps_per_execution=2),
                device)
    before = _entry_counts()
    t.train_multi_step(_stack([batch, batch]), beta)   # eager, then capture
    t.train_multi_step(_stack([batch]), beta)          # one replay
    torch.cuda.synchronize()
    captured = _captured([t])
    main_path.update(_entry_counts() - before)   # replays' launches included
    failed += _replay_against_eager(
        t, batch, beta, f"{label}, one replay from a captured run's state", 2)
    want = {k: n for k, n in launches.items()
            if "_fwd_res_" in k or "_bwd_" in k}
    log(f"{label}: the replay launched {dict(captured)} (expected {want} a "
        f"replay)")
    if dict(captured) != want:
        failed.append(f"{label}: the replay launched {dict(captured)}, "
                      f"expected {want}")
    del t
    torch.cuda.empty_cache()
    return dict(captured)


def coverage_phase(device):
    """Phase 15: SeqVaeTeb at LSTM widths the kernels take only padded
    (lstm_hidden_dim 5, 60, 100), in depth groups (512) or streamed (1024
    fp32, 1536 bf16), fp32 and bf16.
    Returns the kernel entry points' launches over the phase's model runs
    (serving forwards, train steps, the captured run; the comparisons with
    plain versions excluded) and {(H, dtype): the numbers PERF.md
    reports}."""
    import copy
    from vae_teb_tpu_torch import (InferenceServer, SeqVaeTeb, WindowFrontend,
                                   init_parameters, production_frontend)
    from vae_teb_tpu_torch.kernels import wavefront_fwd_plain
    from vae_teb_tpu_torch.models.blocks import padded_width
    t_phase = time.perf_counter()
    failed, main_path, report = [], Counter(), {}
    # (a) the padded shapes at the kernels: two 4-layer streams, K=303
    for h in COVERAGE_PADDED:
        cases = tuple(((4, 4), COVERAGE_BATCH, dt, True)
                      for dt in (torch.float32, torch.bfloat16))
        try:
            report[("kernels", h)] = check_kernels(
                device, 300, h, cases, {torch.float32: LIBRARY_REL_TOL[
                    torch.float32]}, pad_to=padded_width(h), plain_runs=0,
                runs=COVERAGE_TIMED_RUNS)
        except AssertionError as e:
            failed.append(f"(a) H={h}: {e}")
    log(f"coverage (a) took {time.perf_counter() - t_phase:.1f} s")
    t_part = time.perf_counter()

    frontend = WindowFrontend(production_frontend(device))
    gen = torch.Generator(device=device).manual_seed(15)
    wide = init_parameters(SeqVaeTeb(lstm_hidden_dim=COVERAGE_WIDE),
                           seed=INIT_SEED)
    raw_len = wide.decoder.raw_len
    batch = _coefficient_batches(frontend, gen, 1, COVERAGE_BATCH, raw_len,
                                 device)[0]
    eps = torch.randn((COVERAGE_BATCH, raw_len // 16, 32), generator=gen,
                      device=device)
    beta = 1e-5
    # (a) and (b): serving and a train step of SeqVaeTeb at each width
    for h in COVERAGE_PADDED + (COVERAGE_WIDE,):
        fp32 = _at_width(wide, h).to(device)   # copies are made on the card
        fp32_plain = None
        for dtype in (torch.float32, torch.bfloat16):
            model = fp32 if dtype == torch.float32 else _at_width(
                fp32, h, dtype).to(device)
            label = f"coverage SeqVaeTeb(lstm_hidden_dim={h}) {str(dtype)[6:]}"
            groups, n, plain, grads = _model_runs(
                device, model, frontend.frontend, batch, eps, beta, label,
                failed, fp32_plain, both_ways=(
                    h == COVERAGE_WIDE and dtype == torch.float32))
            main_path.update(n)
            report[(h, dtype)] = {"groups": groups, "launches": dict(n)}
            if h == COVERAGE_WIDE:
                _hoisting(device, model, frontend.frontend, batch, eps, beta,
                          plain, grads, fp32_plain, label, failed)
            fp32_plain = plain
            del grads
            if h != COVERAGE_WIDE:
                continue
            times, lib_err, plain_ok = _lstm_times(device, model, batch,
                                                   gen, label)
            report[(h, dtype)].update(lstm_times=times, cudnn_err=lib_err)
            if not plain_ok:
                failed.append(f"{label}: the encoder LSTMs' kernels against "
                              f"the plain recurrence")
            if dtype == torch.float32 and not lib_err <= LIBRARY_REL_TOL[
                    dtype]:
                failed.append(f"{label}: cuDNN yardstick {lib_err}")
            # each group's kernels alone: check_kernels at the group's
            # shape, with times, the bound and cuDNN at that shape
            shapes = sorted({tuple(l1 - l0 for _, l0, l1 in g)
                             for g in groups})
            try:
                report[(h, dtype)]["groups_kernels"] = check_kernels(
                    device, 300, h, tuple((d, COVERAGE_BATCH, dtype, True)
                                          for d in shapes),
                    {torch.float32: LIBRARY_REL_TOL[torch.float32]},
                    plain_runs=0, runs=COVERAGE_TIMED_RUNS)
            except AssertionError as e:
                failed.append(f"(b) {label} groups: {e}")
        log(f"coverage H={h} took {time.perf_counter() - t_part:.1f} s")
        t_part = time.perf_counter()

    # (c) one replay of the wide fp32 step against three eager steps
    report["captured"] = _captured_step(
        device, wide, batch, beta, f"coverage (c) SeqVaeTeb(lstm_hidden_dim="
        f"{COVERAGE_WIDE}) fp32", report[(COVERAGE_WIDE, torch.float32)][
            "launches"], main_path, failed)

    # (d) units over a CTA's shared memory: the streamed grid kernels alone,
    # then the models that need them
    t_part = time.perf_counter()
    report["stream_kernels"] = {}
    for depths, h, dtype in COVERAGE_STREAMED_KERNELS:
        K = 303
        try:
            res = check_kernels(
                device, K - max(depths) + 1, h,
                ((depths, COVERAGE_BATCH, dtype, True),),
                {torch.float32: LIBRARY_REL_TOL[torch.float32]},
                plain_runs=COVERAGE_STREAMED_PLAIN_RUNS,
                runs=COVERAGE_TIMED_RUNS)
        except AssertionError as e:
            failed.append(f"(d) streamed kernels {depths} H={h}: {e}")
            continue
        report["stream_kernels"][(depths, h, dtype)] = res
    # what each launch moves from L2 a step, the rate achieved, and the L2
    # floor: the same launches with the products removed
    floor = _l2_floor(device, COVERAGE_STREAMED_KERNELS)
    report["stream_floor"] = floor
    from vae_teb_tpu_torch.kernels import wavefront
    for (depths, h, dtype), res in report["stream_kernels"].items():
        item = torch.empty((), dtype=dtype).element_size()
        plan = wavefront._launch_plan(
            COVERAGE_BATCH, sum(depths), h, dtype,
            grid_resident=wavefront._card_grid_resident(device, dtype),
            stream_resident=wavefront._card_grid_resident(device, dtype,
                                                          True))
        weights = sum(depths + tuple(d - 1 for d in depths)) * h * 4 * h * item
        for kind in ("fwd", "fwd_res", "bwd"):
            share, chunks, wbytes, rbytes = _stream_traffic(
                plan, depths, h, item, kind != "bwd")
            ms, fl = res[(kind, depths, COVERAGE_BATCH, dtype)][1], floor[
                (kind, depths, h, dtype)]
            rate = lambda t: (wbytes + rbytes) * 303 / (t * 1e-3) / 1e12
            log(f"coverage (d) streamed {kind} {'+'.join(map(str, depths))} "
                f"layers H={h} {str(dtype)[6:]}: N={plan.cols}, clusters of "
                f"{plan.cluster}, resident share {share!r} of {weights} "
                f"weight bytes, (chunks streamed, chunks) a CTA's step "
                f"{chunks}; a step streams {wbytes} weight bytes and reads "
                f"{rbytes} row bytes from L2: kernel {ms!r} ms, "
                f"{rate(ms)!r} TB/s; L2 floor (products removed) {fl!r} ms, "
                f"{rate(fl)!r} TB/s ({card()})")
    report["stream_plans"] = _stream_plans(device, failed)
    log(f"coverage (d) streamed kernels took "
        f"{time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()
    coeffs = [batch[k] for k in ("fhr_st", "fhr_ph", "fhr_up_ph")]
    for h, dtype in COVERAGE_STREAMED:
        fp32 = _at_width(wide, h).to(device)
        label = f"coverage (d) SeqVaeTeb(lstm_hidden_dim={h}) {str(dtype)[6:]}"
        fp32_plain = None
        if dtype == torch.float32:
            model = fp32
        else:    # the bf16 bar: the plain bf16 model's distance from fp32
            server = InferenceServer(copy.deepcopy(fp32), frontend.frontend,
                                     device)
            server.model.recurrence = wavefront_fwd_plain
            fp32_plain = server.infer_coefficients(*coeffs)
            del server
            model = _at_width(fp32, h, dtype).to(device)
            del fp32
        groups, n, _, grads = _model_runs(device, model, frontend.frontend,
                                          batch, eps, beta, label, failed,
                                          fp32_plain)
        del grads
        main_path.update(n)
        report[(h, dtype)] = {"groups": groups, "launches": dict(n)}
        if any("_stream_" not in k for k in n):
            failed.append(f"{label}: a launch off the streamed kernels: "
                          f"{dict(n)}")
        times, lib_err, plain_ok = _lstm_times(device, model, batch, gen,
                                               label)
        report[(h, dtype)].update(lstm_times=times, cudnn_err=lib_err)
        if not plain_ok:
            failed.append(f"{label}: the encoder LSTMs' kernels against the "
                          f"plain recurrence")
        if dtype == torch.float32:
            if not lib_err <= LIBRARY_REL_TOL[dtype]:
                failed.append(f"{label}: cuDNN yardstick {lib_err}")
            report["captured_stream"] = _captured_step(
                device, model, batch, beta, label, report[(h, dtype)][
                    "launches"], main_path, failed)
        del model
        torch.cuda.empty_cache()
        log(f"coverage (d) H={h} took {time.perf_counter() - t_part:.1f} s")
        t_part = time.perf_counter()
    log(f"phase 15 launches: {dict(main_path)}; took "
        f"{time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError("coverage checks failed:\n" + "\n".join(failed))
    return main_path, report


# the decoder's four upsamples of SeqVaeTeb, (C, S) in, at B=128
UPSAMPLE_SHAPES = ((77, 300), (66, 600), (44, 1200), (33, 2400))
UPSAMPLE_B = 128
UPSAMPLE_BWD_TOL = {torch.float32: 1e-6, torch.bfloat16: 8e-3}  # of max|dx|
UPSAMPLE_RUN = 10     # launches a timing in phase 16 (a)


def _upsample_bound_ms(C, S, itemsize):
    """Input read and output written once at 3.35 TB/s, B=128."""
    return 3 * UPSAMPLE_B * C * S * itemsize / HBM_BYTES_PER_S * 1e3


def _upsample_kernel_ms(prof):
    """The device times (ms) of the upsample kernels in a profile, in
    launch order, as (name, ms), and how many upsample_linear1d kernels
    it holds."""
    from vae_teb_tpu_torch.profile_train import _kernels
    kernels = sorted(_kernels(prof), key=lambda e: e.time_range.start)
    ours = [("bwd" if "_bwd_" in e.name else "fwd",
             (e.time_range.end - e.time_range.start) / 1e3)
            for e in kernels if "upsample_linear2x" in e.name]
    return ours, sum("upsample_linear1d" in e.name for e in kernels)


def upsample_phase(device):
    """Phase 16: the decoder's upsample kernels (kernels/upsample.cu). (a)
    At each of the decoder's four shapes at B=128, in its layout (the
    transposed view of a (B, C, S) tensor), fp32 and bf16: the forward
    equal to F.interpolate (fp32) or the plain blends (bf16) bit for bit,
    the gather equal to the plain gather on the card and to itself across
    runs bit for bit, and within UPSAMPLE_BWD_TOL of float64 autograd;
    times (CUDA events around UPSAMPLE_RUN launches, over their count,
    median of 15) of the kernels, the plain versions and PyTorch's
    upsample_linear1d forward and backward (`library_ms`),
    beside the bytes bound (input read and output written once at 3.35
    TB/s). (b) SeqVaeTeb at B=128: the upsample launches of one eval
    forward, one eager train step and one replay of the captured step, and
    from the profiler, the forward's and the replay's upsample kernels'
    device times in place, and no upsample_linear1d kernel. Returns
    {(way, C, S, dtype): (ms, plain_ms, library_ms, bound_ms)} and (b)'s
    {"launches": {...}, "forward_ms": [...], "replay_ms": [...]}."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from vae_teb_tpu_torch import (SeqVaeTeb, Trainer, TrainerConfig,
                                   init_parameters)
    from vae_teb_tpu_torch.kernels import (launch_counts,
                                           upsample_linear2x_bwd,
                                           upsample_linear2x_bwd_plain,
                                           upsample_linear2x_fwd,
                                           upsample_linear2x_fwd_plain)
    log(f"upsample: card {card()}")
    gen = torch.Generator(device=device).manual_seed(16)
    B, out, failed = UPSAMPLE_B, {}, []
    ncw = lambda t: t.transpose(1, 2)
    for dtype in (torch.float32, torch.bfloat16):
        for C, S in UPSAMPLE_SHAPES:
            x = ncw(torch.randn(B, C, S, generator=gen, device=device).to(
                dtype))
            g = ncw(torch.randn(B, C, 2 * S, generator=gen,
                                device=device).to(dtype))
            lib_fwd = lambda: F.interpolate(ncw(x), size=2 * S, mode="linear",
                                            align_corners=False)
            lib_bwd = lambda: torch.ops.aten.upsample_linear1d_backward(
                ncw(g), [2 * S], [B, C, S], False)
            y, dx = upsample_linear2x_fwd(x), upsample_linear2x_bwd(g)
            want_y = (ncw(lib_fwd()) if dtype == torch.float32
                      else upsample_linear2x_fwd_plain(x))
            x64 = x.double().requires_grad_(True)
            (dx64,) = torch.autograd.grad(
                F.interpolate(ncw(x64), size=2 * S, mode="linear",
                              align_corners=False), x64, ncw(g).double())
            err = ((dx.double() - dx64).abs().max() / dx64.abs().max()).item()
            label = f"upsample (a) ({C}, {S}) {str(dtype)[6:]}"
            if not (torch.equal(y, want_y) and ncw(y).is_contiguous()):
                failed.append(f"{label}: forward differs from the "
                              "library (fp32) or plain (bf16) one in "
                              f"{(y != want_y).sum().item()} outputs, or "
                              "not in the input's layout")
            if not torch.equal(dx, upsample_linear2x_bwd_plain(g)):
                failed.append(f"{label}: gather differs from the plain one")
            if not torch.equal(dx, upsample_linear2x_bwd(g)):
                failed.append(f"{label}: gather differs between two runs")
            if err > UPSAMPLE_BWD_TOL[dtype]:
                failed.append(f"{label}: gather {err:.3g} of max from "
                              "float64 autograd")
            bound_ms = _upsample_bound_ms(C, S, x.element_size())
            for way, kernel, plain, lib in (
                    ("fwd", lambda: upsample_linear2x_fwd(x),
                     lambda: upsample_linear2x_fwd_plain(x), lib_fwd),
                    ("bwd", lambda: upsample_linear2x_bwd(g),
                     lambda: upsample_linear2x_bwd_plain(g), lib_bwd)):
                # a run of launches a timing, so that the host's launch
                # latency hides behind the queue as it does in a step
                ms, plain_ms, library_ms = (
                    cuda_time_ms(lambda: [f() for _ in range(UPSAMPLE_RUN)])
                    / UPSAMPLE_RUN for f in (kernel, plain, lib))
                out[(way, C, S, dtype)] = (ms, plain_ms, library_ms, bound_ms)
                log(f"{label} {way}: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
                    f" ms, library {library_ms:.4f} ms, bound {bound_ms:.4f}"
                    f" ms, share of bound {100 * bound_ms / ms:.1f}%" + (
                        f", gather {err:.3g} of max from float64"
                        if way == "bwd" else ""))
            del x, g, y, dx, want_y, x64, dx64
    # (b) the main path at B=128: serving forward, eager step, replay
    model = init_parameters(SeqVaeTeb(), seed=INIT_SEED).to(device)
    keys = (("upsample_linear2x_fwd", "upsample_linear2x_fwd_f32"),
            ("upsample_linear2x_bwd", "upsample_linear2x_bwd_f32"))
    widths = {"fhr_st": 43, "fhr_ph": 44, "fhr_up_ph": 130, "fhr": None}
    batch = lambda: {f: torch.randn((1, B, 300, c) if c else (1, B, 4800),
                                    generator=gen, device=device)
                     for f, c in widths.items()}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    launches, library = {}, 0

    def counted(name, fn):
        nonlocal library
        before = launch_counts()
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        launches[name] = [(launch_counts() - before)[k] for k in keys]
        ours, lib = _upsample_kernel_ms(prof)
        library += lib
        return [ms for _, ms in ours]

    fields = batch()
    with torch.inference_mode():
        forward_ms = counted("forward", lambda: model.eval()(
            *(fields[f][0] for f in ("fhr_st", "fhr_ph", "fhr_up_ph"))))
    trainer = Trainer(model.train(), TrainerConfig(steps_per_execution=1),
                      device)
    counted("train_step",   # eager, then captured
            lambda: trainer.train_multi_step(batch(), 1e-5))
    replay_ms = counted("captured_replay",
                        lambda: trainer.train_multi_step(batch(), 1e-5))
    (graph,) = trainer.graphs.values()
    # in launch order: the forward's shapes, then the backward's reversed
    shapes = list(UPSAMPLE_SHAPES) + list(UPSAMPLE_SHAPES[::-1])
    for name, times in (("forward", forward_ms), ("replay", replay_ms)):
        for (C, S), ms in zip(shapes, times):
            bound = _upsample_bound_ms(C, S, 4)
            log(f"upsample (b) {name}, ({C}, {S}): {ms:.4f} ms in place, "
                f"share of bound {100 * bound / ms:.1f}%")
    log(f"upsample (b) B=128 launches (fwd, bwd): {launches}; upsample "
        f"device time: serving forward {sum(forward_ms):.4f} ms, replay "
        f"{sum(replay_ms):.4f} ms; {library} upsample_linear1d kernels")
    want = {"forward": [4, 0], "train_step": [4, 4],
            "captured_replay": [4, 4]}
    if launches != want or graph.replays != 1 or library:
        failed.append(f"upsample (b): launches {launches}, expected {want};"
                      f" {graph.replays} replays; {library} "
                      "upsample_linear1d kernels")
    if len(forward_ms) != 4 or len(replay_ms) != 8:
        failed.append(f"upsample (b): {len(forward_ms)} / {len(replay_ms)} "
                      "upsample kernels in the profiles, expected 4 / 8")
    if failed:
        raise AssertionError("phase 16 checks failed:\n" + "\n".join(failed))
    return out, {"launches": launches, "forward_ms": forward_ms,
                 "replay_ms": replay_ms}


# the main path's LayerNorm shapes, (rows, width): B * S = 38,400 rows of
# SeqVaeTeb's narrow widths and the forecaster's widest, and the raw heads'
LAYER_NORM_SHAPES = ((38400, 16), (38400, 32), (38400, 64), (38400, 130),
                     (38400, 458), (128, 4800))
LAYER_NORM_RUN = 10       # calls a timed graph in phase 17 (a)
LAYER_NORM_HOST = ((38400, 32), (1200, 64))   # phase 17 (b)
HOST_CALLS = 200
# PyTorch's own LayerNorm kernels, which the main path must not launch
LIBRARY_LAYER_NORM = ("RowwiseMoments", "vectorized_layer_norm",
                      "LayerNormForward", "GammaBetaBackward",
                      "layer_norm_grad_input", "LayerNormBackward")


def _layer_norm_bound_ms(rows, width, way):
    """Bytes at 3.35 TB/s: the forward reads x and writes y and the row
    statistics; the backward reads x, dy and the statistics and writes
    dx (the parameters and their gradients are a row each)."""
    tensors = 2 if way == "fwd" else 3
    return rows * (tensors * width + 2) * 4 / HBM_BYTES_PER_S * 1e3


def _host_us(fns, rounds=61):
    """{name: [host time (us) of one call, a round each]} of the calls
    `fns` ({name: fn}), each timed over HOST_CALLS calls made without
    synchronizing (the card's queue keeps up), the calls taking turns in
    each of `rounds` rounds (the host's noise falls on all alike, so two
    calls' samples of one round form a pair)."""
    samples = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            samples[name].append((time.perf_counter() - t0) / HOST_CALLS
                                 * 1e6)
    torch.cuda.synchronize()
    return samples


def _graph_ms(fn, runs=LAYER_NORM_RUN):
    """Device time (ms) of one fn() call: `runs` calls captured in a CUDA
    graph, its replay timed by `cuda_time_ms`, over `runs` (so the host's
    cost of a call stays out)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(runs):
            fn()
    ms = cuda_time_ms(graph.replay) / runs
    del graph
    return ms


def _layer_norm_kernels(prof):
    """The LayerNorm kernels' device times (ms) in a profile, as (name,
    ms), and the names of PyTorch's LayerNorm kernels it holds."""
    from vae_teb_tpu_torch.profile_train import _kernels
    kernels = _kernels(prof)
    ours = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
            for e in kernels if "layer_norm_fwd_" in e.name
            or "layer_norm_bwd_" in e.name]
    library = sorted({e.name for e in kernels
                      if any(k in e.name for k in LIBRARY_LAYER_NORM)})
    return ours, library


def layer_norm_phase(device):
    """Phase 17: the LayerNorm kernels (kernels/layer_norm.cu). (a) At each
    of LAYER_NORM_SHAPES: y, dx, dgamma and dbeta against the float64
    plain version, within 4x the error of PyTorch's float32 LayerNorm
    (forward and autograd) or 2e-6 of max; the backward equal to itself
    across runs; device times (`_graph_ms`) of the kernels, the plain
    versions and PyTorch's native_layer_norm and native_layer_norm_backward
    (`library_ms`), beside the bytes bound. (b) Host us a call of the eval
    path (`_host_us`): a blocks.LayerNorm module under inference_mode
    against an nn.LayerNorm module with the same eps, and
    `layer_norm_rows` against F.layer_norm, at LAYER_NORM_HOST, failing
    where ours is slower in three rounds of four or more, paired by round.
    (c) `layer_norm_main_phase`, in a process of its own. Returns {(way,
    rows, width): (ms, plain_ms, library_ms, bound_ms, err)}, (b)'s
    {(rows, width): {...}} and (c)'s {"launches": {...}, "forward_ms":
    ..., "replay_ms": ...}."""
    import torch.nn as nn
    import torch.nn.functional as F

    from vae_teb_tpu_torch.kernels import (layer_norm_bwd,
                                           layer_norm_bwd_plain,
                                           layer_norm_fwd,
                                           layer_norm_fwd_plain,
                                           layer_norm_rows)
    from vae_teb_tpu_torch.models.blocks import LAYER_NORM_EPS, LayerNorm
    log(f"layer norm: card {card()}")
    eps = LAYER_NORM_EPS
    gen = torch.Generator(device=device).manual_seed(17)
    rand = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    err = lambda got, want: ((got.double() - want).abs().max()
                             / want.abs().max()).item()
    out, failed = {}, []
    for rows, W in LAYER_NORM_SHAPES:
        x, dy = 3 * rand(rows, W) + 1, rand(rows, W)
        gamma, beta = 1 + 0.1 * rand(W), 0.1 * rand(W)
        y, mean, rstd = layer_norm_fwd(x, gamma, beta, eps)
        grads = layer_norm_bwd(x, dy, mean, rstd, gamma)
        again = layer_norm_bwd(x, dy, mean, rstd, gamma)
        x64, g64, b64, dy64 = (t.double() for t in (x, gamma, beta, dy))
        want_y, mean64, rstd64 = layer_norm_fwd_plain(x64, g64, b64, eps)
        want = (want_y,) + layer_norm_bwd_plain(x64, dy64, mean64, rstd64,
                                                g64)
        xl, gl, bl = (t.clone().requires_grad_(True) for t in (x, gamma, beta))
        yl = F.layer_norm(xl, (W,), gl, bl, eps)
        library = (yl.detach(),) + torch.autograd.grad(yl, (xl, gl, bl), dy)
        label = f"layer norm (a) ({rows}, {W})"
        errs = []
        for name, got, w, lib in zip(("y", "dx", "dgamma", "dbeta"),
                                     (y,) + grads, want, library):
            e, bar = err(got, w), max(4 * err(lib, w), 2e-6)
            errs.append(e)
            log(f"{label} {name}: {e:.3g} of max from float64 (PyTorch's "
                f"{err(lib, w):.3g}, bar {bar:.3g})")
            if e > bar:
                failed.append(f"{label} {name}: {e:.3g} > {bar:.3g}")
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            failed.append(f"{label}: the backward differs between two runs")
        del x64, g64, b64, dy64, want_y, mean64, rstd64, want, xl, yl, library
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [W], gamma,
                                                           beta, eps)
        for way, kernel, plain, lib, e in (
                ("fwd", lambda: layer_norm_fwd(x, gamma, beta, eps),
                 lambda: layer_norm_fwd_plain(x, gamma, beta, eps),
                 lambda: torch.ops.aten.native_layer_norm(x, [W], gamma,
                                                          beta, eps),
                 errs[0]),
                ("bwd", lambda: layer_norm_bwd(x, dy, mean, rstd, gamma),
                 lambda: layer_norm_bwd_plain(x, dy, mean, rstd, gamma),
                 lambda: torch.ops.aten.native_layer_norm_backward(
                     dy, x, [W], lmean, lrstd, gamma, beta,
                     [True, True, True]),
                 max(errs[1:]))):
            ms, plain_ms, library_ms = (_graph_ms(f)
                                        for f in (kernel, plain, lib))
            bound_ms = _layer_norm_bound_ms(rows, W, way)
            out[(way, rows, W)] = (ms, plain_ms, library_ms, bound_ms, e)
            log(f"{label} {way}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms,"
                f" share of bound {100 * bound_ms / ms:.1f}%")
        del x, dy, y, mean, rstd, grads, again, lmean, lrstd
    # (b) host time a call of the eval path
    host = {}
    for rows, W in LAYER_NORM_HOST:
        module = LayerNorm(W).to(device).eval()
        library = nn.LayerNorm(W, eps=eps).to(device).eval()
        x = rand(rows, W)
        with torch.inference_mode():
            samples = _host_us({
                "module": lambda: module(x),
                "nn_layer_norm": lambda: library(x),
                "wrapper": lambda: layer_norm_rows(x, module.weight,
                                                   module.bias, eps),
                "f_layer_norm": lambda: F.layer_norm(
                    x, (W,), module.weight, module.bias, eps)})
        host[(rows, W)] = us = {k: statistics.median(v)
                                for k, v in samples.items()}
        log(f"layer norm (b) ({rows}, {W}) host us a call: "
            + ", ".join(f"{k} {v:.2f}" for k, v in us.items()))
        for ours, theirs in (("module", "nn_layer_norm"),
                             ("wrapper", "f_layer_norm")):
            # paired by round: slower only where it loses in at least
            # three rounds of four (a shared host moves both by more than
            # the medians' gap)
            gaps = [a - b for a, b in zip(samples[ours], samples[theirs])]
            q1, median, q3 = statistics.quantiles(gaps, n=4)
            lost = sum(g > 0 for g in gaps)
            log(f"layer norm (b) ({rows}, {W}) {ours} - {theirs}: median "
                f"{median:.2f} us, quartiles {q1:.2f} / {q3:.2f}, slower in "
                f"{lost} of {len(gaps)} rounds")
            us[f"{ours}_gap_us"] = median
            if q1 > 0:
                failed.append(f"layer norm (b) ({rows}, {W}): {ours} slower "
                              f"than {theirs} in {lost} of {len(gaps)} "
                              f"rounds, median {median:.2f} us")
    # (c) the main path at B=128, in a process of its own
    import os
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--layer-norm-main"], capture_output=True,
                          text=True, timeout=900)
    lines = proc.stdout.splitlines()
    for line in lines[:-1]:
        log(line)
    main_path = {}
    if proc.returncode or not lines:
        failed.append(f"layer norm (c): exit {proc.returncode}: "
                      f"{proc.stderr[-3000:]}")
    else:
        main_path = json.loads(lines[-1])
        failed += main_path.pop("failed")
    if failed:
        raise AssertionError("phase 17 checks failed:\n" + "\n".join(failed))
    return out, host, main_path


def layer_norm_main_phase(device):
    """Phase 17 (c), run by `--layer-norm-main` in a process of its own
    (late in the whole smoke's process the profiler's traces held 109 of
    these 115 kernels, and 339-340 of 345, where the launch counts were
    exact; a fresh process's hold them all): SeqVaeTeb at B=128, the
    launches of one eval forward, one eager train step and one replay of
    the captured step, the kernels' device time in place from the
    profiler, and no PyTorch LayerNorm kernel. Returns {"launches": {...},
    "forward_ms": ..., "replay_ms": ..., "failed": [...]}."""
    from torch.profiler import ProfilerActivity, profile

    from vae_teb_tpu_torch import (SeqVaeTeb, Trainer, TrainerConfig,
                                   init_parameters)
    from vae_teb_tpu_torch.kernels import launch_counts
    gen = torch.Generator(device=device).manual_seed(17)
    model = init_parameters(SeqVaeTeb(), seed=INIT_SEED).to(device)
    keys = (("layer_norm_fwd", "layer_norm_fwd_f32"),
            ("layer_norm_bwd", "layer_norm_bwd_f32"))
    widths = {"fhr_st": 43, "fhr_ph": 44, "fhr_up_ph": 130, "fhr": None}
    batch = lambda: {f: torch.randn((1, 128, 300, c) if c else (1, 128, 4800),
                                    generator=gen, device=device)
                     for f, c in widths.items()}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    launches, library, failed = {}, set(), []

    def counted(name, fn):
        before = launch_counts()
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        launches[name] = [(launch_counts() - before)[k] for k in keys]
        ours, lib = _layer_norm_kernels(prof)
        library.update(lib)
        return sum(ms for _, ms in ours), len(ours)

    fields = batch()
    with torch.inference_mode():
        forward_ms = counted("forward", lambda: model.eval()(
            *(fields[f][0] for f in ("fhr_st", "fhr_ph", "fhr_up_ph"))))
    trainer = Trainer(model.train(), TrainerConfig(steps_per_execution=1),
                      device)
    counted("train_step",   # eager, then captured
            lambda: trainer.train_multi_step(batch(), 1e-5))
    replay_ms = counted("captured_replay",
                        lambda: trainer.train_multi_step(batch(), 1e-5))
    (graph,) = trainer.graphs.values()
    log(f"layer norm (c) B=128 launches (fwd, bwd): {launches}; device "
        f"time (ms, kernels): serving forward {forward_ms}, replay "
        f"{replay_ms}; PyTorch LayerNorm kernels: {sorted(library)}")
    want = {"forward": [115, 0], "train_step": [115, 115],
            "captured_replay": [115, 115]}
    if launches != want or graph.replays != 1 or library:
        failed.append(f"layer norm (c): launches {launches}, expected "
                      f"{want}; {graph.replays} replays; PyTorch LayerNorm "
                      f"kernels {sorted(library)}")
    if forward_ms[1] != 115 or replay_ms[1] != 345:
        failed.append(f"layer norm (c): {forward_ms[1]} / {replay_ms[1]} "
                      "LayerNorm kernels in the profiles, expected 115 / "
                      "345 (a backward entry runs two)")
    return {"launches": launches, "forward_ms": forward_ms[0],
            "replay_ms": replay_ms[0], "failed": failed}


def main(argv) -> int:
    kernels_only, serve_only = argv == ["--kernels"], argv == ["--serve"]
    grid_only, parallel_only = argv == ["--grid"], argv == ["--parallel"]
    capture_only, coverage_only = argv == ["--capture"], argv == ["--coverage"]
    upsample_only = argv == ["--upsample"]
    layer_norm_only = argv == ["--layer-norm"]
    layer_norm_main_only = argv == ["--layer-norm-main"]
    if argv and not (kernels_only or serve_only or grid_only
                     or parallel_only or capture_only or coverage_only
                     or upsample_only or layer_norm_only
                     or layer_norm_main_only):
        print("usage: chip_smoke.py [--kernels | --serve | --grid | "
              "--parallel | --capture | --coverage | --upsample | "
              "--layer-norm | --layer-norm-main]", file=sys.stderr)
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
    sources = ("wavefront_fwd.cu", "wavefront_bwd.cu", "wavefront_grid_fwd.cu",
               "wavefront_grid_bwd.cu", "upsample.cu", "layer_norm.cu")
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
        check_waves(device)
        return 0
    if serve_only:            # phase 4 alone, also on an older checkout
        serve(device)
        return 0
    if grid_only:             # phase 12 (a) alone, also on an older checkout
        check_grid_kernels(device)
        return 0
    if parallel_only:         # phase 13 alone
        parallel_phase(device)
        return 0
    if capture_only:          # phase 14 alone
        capture_phase(device)
        return 0
    if coverage_only:         # phase 15 alone
        coverage_phase(device)
        return 0
    if upsample_only:         # phase 16 alone
        upsample_phase(device)
        return 0
    if layer_norm_only:       # phase 17 alone
        layer_norm_phase(device)
        return 0
    if layer_norm_main_only:  # phase 17 (c), its last line JSON
        print(json.dumps(layer_norm_main_phase(device)))
        return 0
    check_residency(device)

    kernels = check_kernels(device)
    check_waves(device)
    check_single_stream(device)
    launches = serve(device)
    (res_launches, bwd_launches), fp32_times = train(device)
    bf16 = {"bf16_forward": bf16_forward(device),   # per phase
            "bf16_train": train_bf16(device, fp32_times),
            "fit": fit_phase(device)}
    frontend_etl_phase(device)
    eval_launches = eval_phase(device)
    stream_launches, export_launches = stream_export_phase(device)
    grid_kernels = check_grid_kernels(device)
    variant_launches = variants_phase(device)
    parallel_launches = parallel_phase(device)
    captured = capture_phase(device)
    coverage, cov_report = coverage_phase(device)
    upsample, upsample_main = upsample_phase(device)
    layer_norm, layer_norm_host, layer_norm_main = layer_norm_phase(device)

    case = ((4, 4), 32, torch.float32)
    entries = (("wavefront_fwd", "wavefront_fwd.cu", 80, launches, "fwd",
                "wavefront_fwd_bf16", (eval_launches, stream_launches,
                                       export_launches)),
               ("wavefront_fwd_residuals", "wavefront_fwd.cu", 80,
                res_launches, "fwd_res", "wavefront_fwd_res_bf16", (0, 0, 0)),
               ("wavefront_bwd", "wavefront_bwd.cu", 187, bwd_launches, "bwd",
                "wavefront_bwd_bf16", (0, 0, 0)))
    # each kernel's numbers at the main path's training batch (B=32, fp32)
    print(card())
    rows = []
    for name, src, line, n, key, bf16_entry, (n_eval, n_stream,
                                              n_export) in entries:
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
                              for phase, counts in bf16.items()},
            "eval_launches": n_eval, "stream_launches": n_stream,
            "export_launches": n_export,
            "variant_launches": variant_launches.get(
                bf16_entry.replace("_bf16", "_f32"), 0),
            # phase 14: launched by replays of captured train steps
            "captured_launches": {
                dt: captured.get(bf16_entry.replace("_bf16", f"_{dt}"), 0)
                for dt in ("f32", "bf16")},
            # phase 15: the padded and depth-grouped models' runs
            "coverage_launches": {
                dt: coverage.get(bf16_entry.replace("_bf16", f"_{dt}"), 0)
                for dt in ("f32", "bf16")},
            # phase 13, per world and rank: this entry's fp32 launches
            "parallel_launches": {
                world: sum(n for e, n in seen.items() if e.split(" B=")[0]
                           == bf16_entry.replace("_bf16", "_f32"))
                for world, seen in parallel_launches.items()}})
    # the grid kernels at the forecast decoder's LSTM(256, 3), B=32, fp32;
    # their launches are phase 12's model runs'
    grid_case = ((3,), 32, torch.float32)
    for name, src, line, key in (
            ("wavefront_grid_fwd", "wavefront_grid_fwd.cu", 80, "fwd"),
            ("wavefront_grid_fwd_residuals", "wavefront_grid_fwd.cu", 80,
             "fwd_res"),
            ("wavefront_grid_bwd", "wavefront_grid_bwd.cu", 187, "bwd")):
        err, ms, plain_ms, library_ms, (bound_ms, bound_by) = grid_kernels[
            ((3,), 256)][(key,) + grid_case]
        entry = {"fwd": "wavefront_grid_fwd", "fwd_res": "wavefront_grid_fwd_res",
                 "bwd": "wavefront_grid_bwd"}[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"vae_teb_tpu_torch/kernels/{src}",
            "replaces": f"vae_teb_tpu/models/wavefront_pallas.py:{line}",
            "launches": variant_launches.get(f"{entry}_f32", 0),
            "captured_launches": {dt: captured.get(f"{entry}_{dt}", 0)
                                  for dt in ("f32", "bf16")},
            "coverage_launches": {dt: coverage.get(f"{entry}_{dt}", 0)
                                  for dt in ("f32", "bf16")},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "parallel_launches": {
                world: sum(n for e, n in seen.items()
                           if e.split(" B=")[0] == f"{entry}_f32")
                for world, seen in parallel_launches.items()},
            # (max_abs_err, ms, library_ms, bound_ms) at every phase-12
            # shape and storage type, B=32
            "by_shape": {
                f"{'x'.join(map(str, d))}xH{h} {str(dt)[6:]}":
                    [res[(key, d, 32, dt)][i] for i in (0, 1, 3)]
                    + [res[(key, d, 32, dt)][4][0]]
                for (d, h), res in grid_kernels.items()
                for dt in (torch.float32, torch.bfloat16)}})
    # the streamed grid kernels at a group of one layer of both encoder
    # streams of SeqVaeTeb(lstm_hidden_dim=1024), B=32, fp32, K=303; their
    # launches are phase 15's model runs' and (d)'s captured step's replay
    streamed = cov_report["stream_kernels"]
    stream_case = ((1, 1), 1024, torch.float32)
    for name, src, line, key, entry in (
            ("wavefront_grid_fwd_stream", "wavefront_grid_fwd.cu", 80, "fwd",
             "wavefront_grid_fwd_stream"),
            ("wavefront_grid_fwd_stream_residuals", "wavefront_grid_fwd.cu",
             80, "fwd_res", "wavefront_grid_fwd_res_stream"),
            ("wavefront_grid_bwd_stream", "wavefront_grid_bwd.cu", 187, "bwd",
             "wavefront_grid_bwd_stream")):
        err, ms, plain_ms, library_ms, (bound_ms, bound_by) = streamed[
            stream_case][(key, stream_case[0], 32, torch.float32)]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"vae_teb_tpu_torch/kernels/{src}",
            "replaces": f"vae_teb_tpu/models/wavefront_pallas.py:{line}",
            "launches": coverage.get(f"{entry}_f32", 0),
            "coverage_launches": {dt: coverage.get(f"{entry}_{dt}", 0)
                                  for dt in ("f32", "bf16")},
            "captured_launches": {
                dt: cov_report["captured_stream"].get(f"{entry}_{dt}", 0)
                for dt in ("f32", "bf16")},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            # (max_abs_err, ms, plain_ms, library_ms, bound_ms) at each of
            # phase 15 (d)'s shapes, B=32
            "by_shape": {
                f"{'+'.join(map(str, d))} layers H={h} {str(dt)[6:]}":
                    [res[(key, d, 32, dt)][i] for i in (0, 1, 2, 3)]
                    + [res[(key, d, 32, dt)][4][0]]
                for (d, h, dt), res in streamed.items()},
            # the same launches with the streamed products removed (the
            # ablation build of phase 15 (d)), ms
            "l2_floor_ms": {
                f"{'+'.join(map(str, d))} layers H={h} {str(dt)[6:]}": ms
                for (k, d, h, dt), ms in cov_report["stream_floor"].items()
                if k == key}})
    # the decoder's upsample kernels, which replace no TPU kernel: each
    # shape's numbers at B=128, the main path's launches at B=128
    for way in ("fwd", "bwd"):
        rows.append({
            "name": f"upsample_linear2x_{way}", "route": "cuda",
            "source": "vae_teb_tpu_torch/kernels/upsample.cu",
            "replaces": None, **upsample_main,
            "by_shape": {f"({C}, {S}) {str(dt)[6:]}": dict(zip(
                ("ms", "plain_ms", "library_ms", "bound_ms"),
                upsample[(way, C, S, dt)]))
                for C, S in UPSAMPLE_SHAPES
                for dt in (torch.float32, torch.bfloat16)}})
    # the LayerNorm kernels, which replace no TPU kernel: each shape's
    # numbers, the eval path's host time, the main path's launches at B=128
    for way in ("fwd", "bwd"):
        rows.append({
            "name": f"layer_norm_{way}", "route": "cuda",
            "source": "vae_teb_tpu_torch/kernels/layer_norm.cu",
            "replaces": None, **layer_norm_main,
            "host_us": {f"({r}, {w})": us
                        for (r, w), us in layer_norm_host.items()},
            "by_shape": {f"({r}, {w})": dict(zip(
                ("ms", "plain_ms", "library_ms", "bound_ms", "max_err"),
                layer_norm[(way, r, w)])) for r, w in LAYER_NORM_SHAPES}})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
