// Forward wavefront LSTM recurrence for Hopper (sm_90a), on one cooperative
// grid: the shapes the cluster kernel (wavefront_fwd.cu) does not take.
//
// Replaces, with wavefront_fwd.cu, the TPU kernel
// vae_teb_tpu/models/wavefront_pallas.py::_fwd_kernel (launched by
// wavefront_scan_pallas). It computes exactly what wavefront_fwd.cu
// computes, on the same inputs and outputs (see that file's header and
// kernels/wavefront_ref.py): K = S + D - 1 steps of
//
//   gates = h_cat @ W_eff + xs[k] + b          (fp32 accumulate)
//   c' = f * c + i * g,  h' = o * tanh(c')     (fp32 cell math)
//
// with unit u taking (h', c') only when lvec[u] <= k < S + lvec[u], and h,
// c (and, in the *_res_* entry points, the pre-activation gates and the
// carried c of every step) rounded to the storage type.
//
// Why a second design: the cluster kernel keeps a whole unit's 2H x 4H
// weights in one CTA and runs one CTA per unit in a cluster of at most 8.
// The forecast and predict-st decoders' LSTM(256, 3) and LSTM(256, 2) need
// 2 MB of fp32 weights a unit (and 1024 threads), wider encoders (H = 128)
// 512 KB, and 5-layer encoder pairs 10 units: none fits a CTA or a
// cluster. Here the units' columns are spread over the card: one
// cooperative launch of U * H / N CTAs, CTA (u, j) owning state columns
// t0 = j N .. t0 + N - 1 of unit u and their four gate columns, its
// 2H x 4N slice of Wf[u] resident in shared memory for all K steps as mma
// fragments (kernels/wavefront.py::_grid_plan picks N, the cluster size
// and the ring from the card's residency).
//
// What bounds it on the card: not the 2 * H * 4H FMAs per non-zero block,
// per row, per step a unit runs (0.376 ms at B = 32, S = 300, H = 256, 3
// units, at 67 TFLOP/s), but the step's latency: step k of unit u needs
// h[k-1] of units u and u-1 from other CTAs, so every step pays one
// cross-CTA hand-off and one copy through L2 before its product. The
// design keeps that chain short (wavefront_grid.cuh has the machinery):
//   - No grid barrier: a CTA publishes its h_seq[k] columns on its unit's
//     step flag (release), and the producer warp waits, with acquire loads,
//     only on the flags of units u and u-1.
//   - The rows come in two stages (unit u, then unit u-1), each fetched
//     once per cluster of CTAs of unit u: every CTA bulk-copies 1/CS of the
//     rows from L2, multicast into all the cluster's shared memory, so the
//     product of stage 0 starts while stage 1 is in flight.
//   - xs[k] and b are not on the step's path: the producer copies a step's
//     xs slice a step ahead, b once; the carried h and c stay in shared
//     memory (h_fin and c_fin are written once, at the last step).
//   - The product runs on the tensor cores (mma.sync m16n8k8 3xTF32 for
//     fp32 storage, m16n8k16 bf16 for bf16), the weight fragments read as
//     16-byte words; warps split the gate columns' m-tiles and, where there
//     are fewer than 8, the depth.
//
// Streamed weights (entry points wavefront_grid_{fwd,fwd_res}_stream_*,
// the plan kind "stream"): where no N leaves the 2H x 4N slice room in 227
// KB of shared memory (fp32 H over 520, bf16 over 1056), or a unit's CTAs
// at N <= 32 outnumber what the card holds, the same kernel runs with the
// slice in global memory. The wrapper packs every CTA's slice, each (unit,
// column block, stage, chunk of KC depths) one contiguous tile of 4N x KC
// values in A-fragment order (a unit of layer 0 has no feed stage and no
// tile for it), every call, on the stream (kernels/wavefront.py::
// _stream_tiles). Each step is a k-loop over the stages' chunks. What
// bounds it on the card (chip_smoke.py phase 15 (d); PERF.md section 6)
// is not the bytes from L2 (the same launches without their
// products take half to three quarters of the time; keeping chunks
// resident moves nothing) but the step's chain: the hand-off (h[k-1] of
// units u and u-1 from other CTAs), then the product, its k-loop bound by
// its loads and 3xTF32 splits more than by the mma, then the cells and
// the publish. The design takes everything it can off that chain, and
// makes each k-chunk cheap:
//   - a weights warp streams the tiles through a ring of slots of their
//     own as fast as the consumers free them, across step boundaries
//     (they do not depend on the step), so a step's first tiles are in
//     shared memory before its flags are; the last KR chunks of a CTA's
//     step (what the 227 KB hold beside the rings, kernels/wavefront.py::
//     _stream_plan) stay resident for all K steps, the streamed ones come
//     first in a step;
//   - a rows warp waits on the flags and brings the h rows in chunks of up
//     to 2 KB a row with one tensor-map copy a CTA (its 1/CS of the rows,
//     multicast to the cluster, 128-byte swizzled) into a ring of its own;
//   - chunks are as deep as the rings allow, and the consumers free a
//     chunk's slots once they meet (one arrival a CTA), so a step takes
//     few hand-offs; the swizzled B fragments load by ldmatrix, two n8
//     tiles an instruction, free of bank conflicts (a cluster leaves each
//     CTA at least 8 of the pass's rows).
// It computes what the resident mode computes: only the summation order
// differs, each warp's accumulator sets restarting their k-tile count at
// every chunk, which tests/test_torch_streamed.py emulates; the plain
// version (kernels/wavefront_ref.py) is its oracle as it is the resident
// mode's.
//
// Plain C interface: each entry point launches on the given stream and
// returns the CUDA error of the launch (0 on success).

#include "wavefront_grid.cuh"

namespace {

template <typename T>
struct FwdParams {
  RowMaps hmap, imap;  // streamed mode: tensor maps of h_seq and h0
  const T* wf;  // [U][2H/4][4][H][4], wavefront_fwd.cu's layout
  const T* b;
  const T* xs;
  const T* h0;
  const T* c0;
  const int* lvec;
  T* h_seq;
  T* gates_seq;
  T* c_seq;
  T* h_fin;
  T* c_fin;
  unsigned* flags;
  int K, B, U, H, S, N, CS, MB, NBUF;
  // streamed mode: depths a weight chunk and a rows chunk, resident
  // chunks a CTA
  int KC, RC, KR;
};

// Wf[u] at depth dd (own rows 0..H-1, feed rows H..2H-1), gate column
// q H + t, as raw storage bits
template <typename T>
__device__ __forceinline__ unsigned wf_bits(const FwdParams<T>& p, int u,
                                            int dd, int q, int t) {
  const size_t i =
      ((((size_t)u * (p.H / 2) + dd / 4) * 4 + dd % 4) * p.H + t) * 4 + q;
  if (sizeof(T) == 4) return reinterpret_cast<const unsigned*>(p.wf)[i];
  return reinterpret_cast<const unsigned short*>(p.wf)[i];
}

// NT: n8 tiles of batch rows a pass, 1-4; STREAM: the streamed mode, whose
// warps take MTW m-tiles each (2 at N = 64, else 1)
template <typename T, bool RESIDUALS, int NT, bool STREAM, int MTW>
__global__ void __launch_bounds__(STREAM ? STREAM_THREADS : THREADS, 1)
    wavefront_grid_fwd_kernel(const __grid_constant__ FwdParams<T> p) {
  constexpr bool TF32 = sizeof(T) == 4;
  constexpr int SETS = sets_for(NT);
  constexpr int NTHREADS = STREAM ? STREAM_THREADS : THREADS;
  const int K = p.K, B = p.B, H = p.H, N = p.N, CS = p.CS, MB = p.MB;
  // CTAs a unit: the streamed mode's last one may own fewer than N columns
  const int NBUF = p.NBUF, UH = p.U * H, G = 4 * UH;
  const int per_unit = (H + N - 1) / N;
  const int u = blockIdx.x / per_unit, t0 = (blockIdx.x % per_unit) * N;
  const int nv = min(N, H - t0);  // this CTA's columns
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int layer = p.lvec[u];
  const int nstage = layer > 0 ? 2 : 1;  // unit u, then unit u-1
  const Layout L = STREAM
                       ? stream_layout<T, true>(N, MB, CS, NBUF, p.KC, p.RC, p.KR)
                       : grid_layout<T, true>(H, N, MB, NBUF);
  const int KTT = L.stages * L.kts;
  const int E = (B + MB - 1) / MB * K;  // steps of all passes
  // streamed mode: weight chunks a stage and a step, the step's streamed
  // chunks (the first nstr; the other min(KR, nch) resident), rows chunks
  // a stage and weight chunks a rows chunk, and this CTA's first weight
  // tile
  const int nc = STREAM ? (H + p.KC - 1) / p.KC : 0;
  const int nch = nstage * nc, nstr = max(0, nch - p.KR);
  const int ncr = STREAM ? (H + p.RC - 1) / p.RC : 0;
  const int per = STREAM ? p.RC / p.KC : 1;
  const size_t tile = L.wt / sizeof(T);
  const T* tiles =
      STREAM ? p.wf + (units_tiles(u, per_unit, nc,
                                   [&](int v) {
                                     return p.lvec[v] > 0 ? 2 : 1;
                                   }) +
                       (size_t)(t0 / N) * nstage * nc) *
                          tile
             : nullptr;

  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned bars = smem_addr(smem);
  unsigned* w_s = reinterpret_cast<unsigned*>(smem + L.w);
  const T* buf_s = reinterpret_cast<const T*>(smem + L.buf);
  float* part = reinterpret_cast<float*>(smem + L.part);
  T* in_s = reinterpret_cast<T*>(smem + L.in);
  float* b_s = reinterpret_cast<float*>(smem + L.bias);
  float* h_c = reinterpret_cast<float*>(smem + L.carry);  // [MB][N]
  float* c_c = h_c + MB * N;

  if (STREAM)
    stream_init_barriers(bars, NBUF, CS);
  else
    grid_init_barriers(bars, NBUF, CS);
  // the rows' ring starts zeroed: a chunk shorter than KC leaves earlier
  // rows' (finite) values in its pieces past H, which meet zero weights
  for (int i = tid; i < (int)(((STREAM ? L.w : L.part) - L.buf) / 16);
       i += NTHREADS)
    reinterpret_cast<uint4*>(smem + L.buf)[i] = make_uint4(0, 0, 0, 0);
  // A fragments of the weight slice: [mt][KTT][lane][4], register r of
  // lane (g, t) holding A[m][d] at m = 16 mt + g (+8 for r odd), d = kw j +
  // (t, or 2t and 2t+1 for bf16) (+kw/2 for r >= 2); A[q N + c][s H + d] =
  // Wf[u][s H + d][q H + t0 + c], zero past H and for a missing stage. The
  // streamed mode's tiles hold the same fragments, [mt][kpc][lane][4] a
  // chunk.
  for (int i = tid; !STREAM && i < L.mt * KTT * 128; i += NTHREADS) {
    const int r = i & 3, ln = (i >> 2) & 31, f = i >> 7;
    const int kt = f % KTT, mtile = f / KTT, s = kt / L.kts;
    const int m = mtile * 16 + ln / 4 + (r & 1) * 8, q = m / N, c = m % N;
    int d = (kt % L.kts) * L.kw + (r >> 1) * (L.kw / 2);
    unsigned v = 0;
    if (TF32) {
      d += ln % 4;
      if (d < H && s < nstage) v = wf_bits(p, u, s * H + d, q, t0 + c);
    } else {
      d += 2 * (ln % 4);
      if (d < H && s < nstage)
        v = wf_bits(p, u, s * H + d, q, t0 + c) |
            wf_bits(p, u, s * H + d + 1, q, t0 + c) << 16;
    }
    w_s[i] = v;
  }
  for (int i = tid; i < 4 * N; i += NTHREADS)
    b_s[i] = i % N < nv ? load_f32(p.b + (i / N) * UH + u * H + t0 + i % N)
                        : 0.f;
  grid_start(CS);

  const bool ring = NBUF < nstage;  // else stage s keeps buffer s

  if (STREAM && warp == WARPS) {
    // ---- streamed mode's weights: the resident chunks once, then the
    // streamed chunks of every step in order, each as soon as the ring
    // has a free slot ----
    if (lane == 0) {
      if (nstr < nch) {
        mbar_expect(res_bar(bars), (unsigned)((nch - nstr) * L.wt));
        bulk_copy(smem_addr(smem + L.res), tiles + (size_t)nstr * tile,
                  (unsigned)((nch - nstr) * L.wt), res_bar(bars));
      }
      const unsigned wring = smem_addr(smem + L.w);
      for (int n = 0, i = 0, slot = 0, use = 0; n < E * nstr; ++n) {
        if (use > 0) mbar_wait(wempty_bar(bars, slot), (use - 1) & 1);
        mbar_expect(wfull_bar(bars, slot), (unsigned)L.wt);
        bulk_copy(wring + slot * (unsigned)L.wt, tiles + (size_t)i * tile,
                  (unsigned)L.wt, wfull_bar(bars, slot));
        if (++i == nstr) i = 0;
        if (++slot == NBUF) slot = 0, ++use;
      }
    }
    __syncwarp();
  } else if (warp >= WARPS) {
    // ---- producer (streamed mode: the rows warp): the stages of every
    // step, the inputs a step ahead ----
    const unsigned rank = CS > 1 ? cluster_rank() : 0;
    const unsigned short mask = (unsigned short)((1u << CS) - 1);
    const unsigned seg = H * sizeof(T);
    const unsigned ring_s = smem_addr(smem + L.buf);
    const unsigned* own = p.flags + u * FLAG_STRIDE;
    // xs[k] of step e: per row 4 gate segments of N values, lane l taking
    // segment l % 4 of rows l / 4, l / 4 + 8, ..., 16 bytes a copy
    const int V = 16 / sizeof(T), q_in = lane % 4;
    auto inputs = [&](int e) {
      const int j = e & 1, k = e % K, r0 = e / K * MB, rows = min(MB, B - r0);
      for (int m = lane / 4; m < rows; m += 8) {
        T* dst = in_s + ((size_t)(j * MB + m) * 4 + q_in) * N;
        const T* src =
            p.xs + ((size_t)k * B + r0 + m) * G + q_in * UH + u * H + t0;
        for (int v = 0; v < nv; v += V) cp_async16(dst + v, src + v);
      }
      cp_async_arrive(in_bar(bars, j));
    };
    int g = 0;
    inputs(0);
    for (int e = 0; e < E; ++e) {
      const int kk = e % K, r0 = e / K * MB, rows = min(MB, B - r0);
      const T* src = kk ? p.h_seq + (size_t)(kk - 1) * B * UH : p.h0;
      // a new pass reads h0, but refills buffers the last pass read
      if (kk == 0 && e > 0) wait_flag(own, e * per_unit, lane);
      for (int s = 0; STREAM && s < nstage; ++s) {
        if (kk > 0)
          wait_flag(p.flags + (u - s) * FLAG_STRIDE, e * per_unit, lane);
        for (int c = 0; c < ncr; ++c, ++g) {
          // slot g % NBUF of the rows' ring: rows chunk c's h columns
          const int slot = g % NBUF, use = g / NBUF;
          if (use > 0) mbar_wait(empty_bar(bars, slot), (use - 1) & 1);
          if (lane == 0)
            copy_rows(kk ? p.hmap : p.imap, L, H, sizeof(T), c, u - s,
                      kk ? kk - 1 : 0, r0, rank, CS,
                      ring_s + slot * (unsigned)L.slot, full_bar(bars, slot));
          __syncwarp();
        }
      }
      for (int s = 0; !STREAM && s < nstage; ++s, ++g) {
        // h_seq[kk-1] of unit u - s is complete
        if (kk > 0)
          wait_flag(p.flags + (u - s) * FLAG_STRIDE, e * per_unit, lane);
        const Slot sl = stage_slot(ring, NBUF, g, s, e);
        if (ring && sl.use > 0)
          mbar_wait(empty_bar(bars, sl.buf), (sl.use - 1) & 1);
        if (lane == 0) mbar_expect(full_bar(bars, sl.buf), rows * seg);
        __syncwarp();
        const unsigned dst = ring_s + sl.buf * L.rows * L.rs * sizeof(T);
        for (int r = rank + CS * lane; r < rows; r += 32 * CS) {
          const T* row = src + (size_t)(r0 + r) * UH + (u - s) * H;
          if (CS > 1)
            bulk_copy_mc(dst + r * L.rs * sizeof(T), row, seg,
                         full_bar(bars, sl.buf), mask);
          else
            bulk_copy(dst + r * L.rs * sizeof(T), row, seg,
                      full_bar(bars, sl.buf));
        }
      }
      // step e+1's inputs take the buffer of step e-1, which this CTA is
      // done with: its unit's flag counted step e-1 above
      if (e + 1 < E) inputs(e + 1);
    }
  } else {
    // ---- consumers: the product, then the cells ----
    const int wmt = L.mt < WARPS ? L.mt : WARPS;  // m-tiles a round of warps
    const int mtile = warp % wmt, slice = warp / wmt;
    // streamed mode: the rows slot's rows this lane gives ldmatrix, for
    // each pair of n8 tiles (2q, 2q + 1): row 8 (2q + l / 16) + l % 8, unit
    // half (l / 8) % 2 (the last tile of an odd NT alone, by x2); the
    // rings' next slots and phases
    constexpr int NQ = (NT + 1) / 2;
    SwzRow brow[NQ];
    const unsigned bhalf = (lane >> 3) & 1;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      brow[q] = STREAM ? swz_row(L, smem_addr(smem + L.buf),
                                 min(2 * q + (lane >> 4), NT - 1) * 8 +
                                     (lane & 7))
                       : SwzRow{0, 0};
    int g = 0, rslot = 0, rpar = 0, wslot = 0, wpar = 0;
    for (int e = 0; e < E; ++e) {
      const int kk = e % K, r0 = e / K * MB, rows = min(MB, B - r0);
      const bool valid = layer <= kk && kk < p.S + layer;
      float acc[MTW][SETS][NT][3][4];
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi) zero_acc(acc[mi]);
      // streamed mode: each stage's rows chunks, each over its weight
      // chunks, the step's weight chunk i: the streamed ones (from their
      // ring) first, then the resident ones
      for (int s = 0, i = 0; STREAM && s < nstage; ++s) {
        for (int r = 0; r < ncr; ++r) {
          mbar_wait(full_bar(bars, rslot), rpar);
          const unsigned rs = smem_addr(smem + L.buf) + rslot * (unsigned)L.slot;
          unsigned bt[NT][2];  // this k-tile's B fragments, by ldmatrix
          for (int c = r * per; c < min(nc, (r + 1) * per); ++c, ++i) {
            const bool streamed = i < nstr;
            const unsigned char* wp;
            if (streamed) {
              mbar_wait(wfull_bar(bars, wslot), wpar);
              wp = smem + L.w + (size_t)wslot * L.wt;
            } else {
              if (e == 0 && i == nstr) mbar_wait(res_bar(bars), 0);
              wp = smem + L.res + (size_t)(i - nstr) * L.wt;
            }
            const int kv = (min(p.KC, H - c * p.KC) + L.kw - 1) / L.kw;
            const int p0 = (c - r * per) * L.kpc / 4;  // its first piece
#ifndef WAVEFRONT_STREAM_NO_PRODUCT
#pragma unroll
            for (int mi = 0; mi < MTW; ++mi) {
              const uint4* wf4 = reinterpret_cast<const uint4*>(wp) +
                                 (mtile + mi * WARPS) * L.kpc * 32 + lane;
              // B: h of batch rows 8n + g at the k-tile's 32 bytes (words
              // t, t + 4)
              stage_product<T, NT, SETS>(
                  acc[mi], slice, kv, L.ks,
                  [&](int j, unsigned (&a)[4]) {
                    const uint4 wv = wf4[j * 32];
                    a[0] = wv.x;
                    a[1] = wv.y;
                    a[2] = wv.z;
                    a[3] = wv.w;
                  },
                  [&](int j, int n, unsigned (&b)[2]) {
                    if (n % 2 == 0) {  // n8 tiles n, n + 1 in one ldmatrix
                      const unsigned a =
                          swz_addr(L, brow[n / 2], rs, p0, j, bhalf);
                      if (n + 1 < NT)
                        ldsm_x4(a, bt[n][0], bt[n][1], bt[n + 1][0],
                                bt[n + 1][1]);
                      else
                        ldsm_x2(a, bt[n][0], bt[n][1]);
                    }
                    b[0] = bt[n][0];
                    b[1] = bt[n][1];
                  });
            }
#endif
            const bool last = c + 1 == min(nc, (r + 1) * per);
            release_chunk(streamed ? wempty_bar(bars, wslot) : 0u,
                          last ? empty_bar(bars, rslot) : 0u, CS, warp, lane);
            if (streamed && ++wslot == NBUF) wslot = 0, wpar ^= 1;
          }
          if (++rslot == NBUF) rslot = 0, rpar ^= 1;
        }
      }
      for (int s = 0; !STREAM && s < nstage; ++s, ++g) {
        const Slot sl = stage_slot(ring, NBUF, g, s, e);
        mbar_wait(full_bar(bars, sl.buf), sl.use & 1);
        const T* stg = buf_s + (size_t)sl.buf * L.rows * L.rs;
        // A: the weight fragment; B: h of batch rows 8n + g at depth kw j
        // + t (+4), or the bf16 pairs at 2t (+8): 32-bit words t, t + 4
        const uint4* wf4 = reinterpret_cast<const uint4*>(w_s) +
                           (mtile * KTT + s * L.kts) * 32 + lane;
        stage_product<T, NT, SETS>(
            acc[0], slice, L.kts, L.ks,
            [&](int j, unsigned (&a)[4]) {
              const uint4 wv = wf4[j * 32];
              a[0] = wv.x;
              a[1] = wv.y;
              a[2] = wv.z;
              a[3] = wv.w;
            },
            [&](int j, int n, unsigned (&b)[2]) {
              const unsigned* hw = reinterpret_cast<const unsigned*>(
                  stg + (size_t)(n * 8 + g8) * L.rs + j * L.kw);
              b[0] = hw[t4];
              b[1] = hw[t4 + 4];
            });
        if (ring) release_stage(empty_bar(bars, sl.buf), CS, warp, lane);
      }
      // this slice's sums: D[m][n] at m = 16 mtile + g (+8), n = 8 nt + 2t
      // (+1) -> part[slice][n][m]
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = (mtile + mi * WARPS) * 16 + g8 + (i / 2) * 8;
            const int row = n * 8 + 2 * t4 + i % 2;
            part[((size_t)slice * L.rows + row) * L.ps + m] =
                acc_sum(acc[mi], n, i, TF32);
          }
      consumers_sync();
      // cells: the pass's rows x N; the carried h, c stay in shared memory
      mbar_wait(in_bar(bars, e & 1), (e >> 1) & 1);
      const T* xin = in_s + (size_t)(e & 1) * MB * 4 * N;
      for (int cell = tid; cell < rows * N; cell += CONSUMERS) {
        const int m = cell / N, c = cell % N, row = r0 + m;
        const int col = u * H + t0 + c;
        if (c >= nv) continue;
        float gq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* pp = part + (size_t)m * L.ps + q * N + c;
          float dot = pp[0];
          for (int s = 1; s < L.ks; ++s)
            dot = __fadd_rn(dot, pp[(size_t)s * L.rows * L.ps]);
          gq[q] = __fadd_rn(__fadd_rn(dot, load_f32(xin + (m * 4 + q) * N + c)),
                            b_s[q * N + c]);
        }
        float hv, cv;
        if (kk == 0) {
          hv = load_f32(p.h0 + (size_t)row * UH + col);
          cv = load_f32(p.c0 + (size_t)row * UH + col);
        } else {
          hv = h_c[cell];
          cv = c_c[cell];
        }
        if (valid) {
          const float ig = sigmoid(gq[0]), fg = sigmoid(gq[1]);
          const float gt = tanhf(gq[2]), og = sigmoid(gq[3]);
          const float c_new = __fadd_rn(__fmul_rn(fg, cv), __fmul_rn(ig, gt));
          const float h_new = __fmul_rn(og, tanhf(c_new));
          hv = round_to(h_new, p.h0);
          cv = round_to(c_new, p.h0);
        }
        h_c[cell] = hv;
        c_c[cell] = cv;
        const size_t off = ((size_t)kk * B + row) * UH + col;
        store(p.h_seq + off, hv);
        if (RESIDUALS) {
          store(p.c_seq + off, cv);
          T* gp = p.gates_seq + ((size_t)kk * B + row) * G + col;
#pragma unroll
          for (int q = 0; q < 4; ++q) store(gp + q * UH, gq[q]);
        }
        if (kk == K - 1) {
          store(p.h_fin + (size_t)row * UH + col, hv);
          store(p.c_fin + (size_t)row * UH + col, cv);
        }
      }
      consumers_sync();  // every h_seq[kk] store of this CTA is issued
      if (tid == 0) publish_step(p.flags + u * FLAG_STRIDE);
    }
  }
  grid_end(CS);
}

// the kernel for `nt` n8 tiles of batch rows a pass, resident or streamed
// (with `mtw` m-tiles a warp)
template <typename T, bool RESIDUALS, bool STREAM, int MTW>
const void* kernel_for(int nt) {
  switch (nt) {
    case 1:
      return (const void*)wavefront_grid_fwd_kernel<T, RESIDUALS, 1, STREAM,
                                                    MTW>;
    case 2:
      return (const void*)wavefront_grid_fwd_kernel<T, RESIDUALS, 2, STREAM,
                                                    MTW>;
    case 3:
      return (const void*)wavefront_grid_fwd_kernel<T, RESIDUALS, 3, STREAM,
                                                    MTW>;
    case 4:
      return (const void*)wavefront_grid_fwd_kernel<T, RESIDUALS, 4, STREAM,
                                                    MTW>;
  }
  return nullptr;
}

template <typename T, bool RESIDUALS, bool STREAM>
int launch(const void* w, const void* b, const void* xs, const void* h0,
           const void* c0, const void* lvec, void* h_seq, void* gates_seq,
           void* c_seq, void* h_fin, void* c_fin, void* flags, int K, int B,
           int U, int H, int S, int N, int CS, int MB, int NBUF, int KC,
           int RC, int KR, int smem, void* stream) {
  const int item = (int)sizeof(T);
  const Layout L = STREAM ? stream_layout<T, true>(N, MB, CS, NBUF, KC, RC, KR)
                          : grid_layout<T, true>(H, N, MB, NBUF);
  if (STREAM ? !stream_args_ok(H, N, CS, MB, NBUF, KC, RC, KR, item, smem,
                               L.total)
             : !grid_args_ok(H, N, CS, MB, NBUF, smem, L.total) || NBUF > 2)
    return (int)cudaErrorInvalidValue;
  FwdParams<T> p = {};
  p.wf = (const T*)w;
  p.b = (const T*)b;
  p.xs = (const T*)xs;
  p.h0 = (const T*)h0;
  p.c0 = (const T*)c0;
  p.lvec = (const int*)lvec;
  p.h_seq = (T*)h_seq;
  p.gates_seq = (T*)gates_seq;
  p.c_seq = (T*)c_seq;
  p.h_fin = (T*)h_fin;
  p.c_fin = (T*)c_fin;
  p.flags = (unsigned*)flags;
  p.K = K, p.B = B, p.U = U, p.H = H, p.S = S, p.N = N, p.CS = CS;
  p.MB = MB, p.NBUF = NBUF, p.KC = KC, p.RC = RC, p.KR = KR;
  if (STREAM) {  // h rows at U H values, a step's B rows
    const size_t row = (size_t)U * H * item, step = (size_t)B * row;
    int err = row_maps<T>(&p.hmap, h_seq, H, U, B, K, row, step, L);
    if (!err) err = row_maps<T>(&p.imap, h0, H, U, B, 1, row, step, L);
    if (err) return err;
  }
  const void* kernel = STREAM && N == 64
                           ? kernel_for<T, RESIDUALS, true, 2>(L.nt)
                           : kernel_for<T, RESIDUALS, STREAM, 1>(L.nt);
  return grid_launch(kernel, &p, U * ((H + N - 1) / N), CS, smem, stream,
                     STREAM ? STREAM_THREADS : THREADS);
}

}  // namespace

#define GRID_FWD_ARGS                                                        \
  const void *w, const void *b, const void *xs, const void *h0,             \
      const void *c0, const void *lvec, void *h_seq
#define GRID_FWD_INTS                                                        \
  void *h_fin, void *c_fin, void *flags, int K, int B, int U, int H, int S, \
      int N, int CS, int MB, int NBUF, int smem, void *stream

extern "C" int wavefront_grid_fwd_f32(GRID_FWD_ARGS, GRID_FWD_INTS) {
  return launch<float, false, false>(w, b, xs, h0, c0, lvec, h_seq, nullptr,
                                     nullptr, h_fin, c_fin, flags, K, B, U, H,
                                     S, N, CS, MB, NBUF, 0, 0, 0, smem, stream);
}

extern "C" int wavefront_grid_fwd_bf16(GRID_FWD_ARGS, GRID_FWD_INTS) {
  return launch<__nv_bfloat16, false, false>(
      w, b, xs, h0, c0, lvec, h_seq, nullptr, nullptr, h_fin, c_fin, flags, K,
      B, U, H, S, N, CS, MB, NBUF, 0, 0, 0, smem, stream);
}

extern "C" int wavefront_grid_fwd_res_f32(GRID_FWD_ARGS, void* gates_seq,
                                          void* c_seq, GRID_FWD_INTS) {
  return launch<float, true, false>(w, b, xs, h0, c0, lvec, h_seq, gates_seq,
                                    c_seq, h_fin, c_fin, flags, K, B, U, H, S,
                                    N, CS, MB, NBUF, 0, 0, 0, smem, stream);
}

extern "C" int wavefront_grid_fwd_res_bf16(GRID_FWD_ARGS, void* gates_seq,
                                           void* c_seq, GRID_FWD_INTS) {
  return launch<__nv_bfloat16, true, false>(
      w, b, xs, h0, c0, lvec, h_seq, gates_seq, c_seq, h_fin, c_fin, flags, K,
      B, U, H, S, N, CS, MB, NBUF, 0, 0, 0, smem, stream);
}

// The streamed mode: `w` is the wrapper's tiles (kernels/wavefront.py::
// _stream_tiles), NBUF the slots of each of its rings (rows, weights), KC
// the depths of a weight chunk, RC those of a rows chunk (whole weight
// chunks), KR the resident chunks a CTA; the other arguments as above.
// Returns the CUDA error of the launch, or 10000 + the CUresult of
// cuTensorMapEncodeTiled where it refuses a tensor map.
#define GRID_FWD_STREAM_INTS                                                 \
  void *h_fin, void *c_fin, void *flags, int K, int B, int U, int H, int S, \
      int N, int CS, int MB, int NBUF, int KC, int RC, int KR, int smem,  \
      void *stream

extern "C" int wavefront_grid_fwd_stream_f32(GRID_FWD_ARGS,
                                             GRID_FWD_STREAM_INTS) {
  return launch<float, false, true>(w, b, xs, h0, c0, lvec, h_seq, nullptr,
                                    nullptr, h_fin, c_fin, flags, K, B, U, H,
                                    S, N, CS, MB, NBUF, KC, RC, KR, smem, stream);
}

extern "C" int wavefront_grid_fwd_stream_bf16(GRID_FWD_ARGS,
                                              GRID_FWD_STREAM_INTS) {
  return launch<__nv_bfloat16, false, true>(
      w, b, xs, h0, c0, lvec, h_seq, nullptr, nullptr, h_fin, c_fin, flags, K,
      B, U, H, S, N, CS, MB, NBUF, KC, RC, KR, smem, stream);
}

extern "C" int wavefront_grid_fwd_res_stream_f32(GRID_FWD_ARGS,
                                                 void* gates_seq, void* c_seq,
                                                 GRID_FWD_STREAM_INTS) {
  return launch<float, true, true>(w, b, xs, h0, c0, lvec, h_seq, gates_seq,
                                   c_seq, h_fin, c_fin, flags, K, B, U, H, S,
                                   N, CS, MB, NBUF, KC, RC, KR, smem, stream);
}

extern "C" int wavefront_grid_fwd_res_stream_bf16(GRID_FWD_ARGS,
                                                  void* gates_seq, void* c_seq,
                                                  GRID_FWD_STREAM_INTS) {
  return launch<__nv_bfloat16, true, true>(
      w, b, xs, h0, c0, lvec, h_seq, gates_seq, c_seq, h_fin, c_fin, flags, K,
      B, U, H, S, N, CS, MB, NBUF, KC, RC, KR, smem, stream);
}

// How many CTAs of the residual forward (four n8 tiles) the card holds at
// once in clusters of CS with `smem` bytes of shared memory, or minus the
// CUDA error. The serving variant and the narrower ones have the same
// shared memory and no more registers.
extern "C" int wavefront_grid_fwd_max_ctas(int bf16, int CS, int smem) {
  return grid_max_ctas(bf16 ? kernel_for<__nv_bfloat16, true, false, 1>(4)
                            : kernel_for<float, true, false, 1>(4),
                       smem, CS);
}

// ... of the streamed residual forward (four n8 tiles, two m-tiles a warp)
extern "C" int wavefront_grid_fwd_stream_max_ctas(int bf16, int CS,
                                                  int smem) {
  return grid_max_ctas(bf16 ? kernel_for<__nv_bfloat16, true, true, 2>(4)
                            : kernel_for<float, true, true, 2>(4),
                       smem, CS, STREAM_THREADS);
}
