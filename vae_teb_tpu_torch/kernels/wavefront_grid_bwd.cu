// Reverse wavefront LSTM recurrence for Hopper (sm_90a), on one cooperative
// grid: the shapes the cluster kernel (wavefront_bwd.cu) does not take.
//
// Replaces, with wavefront_bwd.cu, the TPU kernel
// vae_teb_tpu/models/wavefront_pallas.py::_bwd_kernel (launched by
// wavefront_bwd_pallas). It computes exactly what wavefront_bwd.cu
// computes, on the same inputs and outputs (see that file's header and
// kernels/wavefront_ref.py::wavefront_bwd_plain): per reverse step k the
// dgates of every cell from the stored gates and c, the carried (dh, dc)
// and dY[k], zero for idle units; dz = dgates @ W_eff^T; dh' = dz (+ dh_tot
// for idle units), dc' = dct * f (dc for idle units), with dh, dc and the
// dgates rounded to the storage type.
//
// Design, on the grid of wavefront_grid_fwd.cu (wavefront_grid.cuh has the
// machinery): U * H / N CTAs, CTA (u, j) owning state columns t0 = j N ..
// t0 + N - 1 of unit u, with the W_eff^T rows that produce dh for them
// (unit u's recurrent block and unit u+1's feed block, [8H][N], read out of
// the wrapper's Wb layout [U][8H][H]) resident in shared memory for all K
// steps as mma fragments. Step k:
//   - cells: the CTA's dgates of step k from the carried dh, dc (shared
//     memory; dh_fin and dc_fin are written once, at the end) and the
//     step's stored gates, c, c_prev and dY, which the producer warp copied
//     a step or two ahead; the dgates go to dgates_seq[k], and the CTA
//     publishes them on its unit's step flag (release);
//   - product: dz = [dg_u | dg_{u+1}] @ W rows over 8H (4H when unit u+1
//     is not fed by u). The producer waits, with acquire loads, only on the
//     flags of units u and u+1, then brings the dgates in eight stages (one
//     unit's gate q each, all the pass's rows), fetched once per cluster
//     of CTAs of unit u: each CTA bulk-copies 1/CS of the rows from L2,
//     multicast into the cluster's shared memory, into a ring of up to 8
//     buffers, so the product of one stage overlaps the copies of the next.
//     The product runs on the tensor cores (mma.sync m16n8k8 3xTF32 for
//     fp32 storage, m16n8k16 bf16 for bf16), the batch rows as M, the N
//     columns as n8 tiles, the depth split over the warps.
// What bounds it on the card: not the 2 * H * 4H FMAs per non-zero block,
// per row, per step a unit runs (0.376 ms at B = 32, S = 300, H = 256, 3
// units, at 67 TFLOP/s), but the step's latency: its product needs two
// units' dgates of the same step from other CTAs (a flag and a copy through
// L2), and it moves 4x the forward's rows (8H a row), which at fp32 and H =
// 256 do not all fit in shared memory at once: the ring refills a buffer
// once every CTA of the cluster is done with it.
//
// Streamed weights (entry points wavefront_grid_bwd_stream_*, the plan
// kind "stream"), for the shapes whose 8H x N slice does not fit a CTA's
// shared memory, as in wavefront_grid_fwd.cu: the wrapper packs each
// (unit, column block, stage, chunk of KC depths) as one contiguous tile
// of KC x N values in B-fragment order (a unit that feeds no unit above it
// has no tile for stages 4-7), and each step's product is a k-loop over
// the stages' chunks. What bounds it on the card, as in the forward, is
// the step's chain (the hand-off of two units' dgates, the product, the
// cells), not the bytes from L2: each CTA's slice and 1/CS of the step's
// dgates rows, four stages of them (8H values a row against the forward's
// 2H). The design is the forward's: the last KR chunks of a CTA's step
// stay resident in shared memory for all K steps; a weights warp streams
// the others through a ring of their own across step boundaries, so that
// they arrive while the step's cells run and its flags are awaited; a
// rows warp brings the dgates in chunks of up to 2 KB a row with one
// 128-byte swizzled tensor-map copy a CTA, multicast to the cluster, into
// a second ring; the consumers free a chunk's slots once they meet, and
// load the A fragments (rows 16 mtile + g, + 8, at k t, t + 4) by one
// ldmatrix a k-tile. Only the summation order differs from the resident
// mode (each warp's accumulator sets restart their k-tile count at every
// weight chunk); the plain version (kernels/wavefront_ref.py::
// wavefront_bwd_plain) is its oracle.
//
// Plain C interface: each entry point launches on the given stream and
// returns the CUDA error of the launch (0 on success).

#include "wavefront_grid.cuh"

namespace {

template <typename T>
struct BwdParams {
  RowMaps dmap;  // streamed mode: tensor maps of dgates_seq
  const T* wb;  // [U][8H][H]
  const T* gates_seq;
  const T* c_seq;
  const T* c_prev_seq;
  const T* dy;
  const T* dh0;
  const T* dc0;
  const int* lvec;
  T* dgates_seq;
  T* dh_fin;
  T* dc_fin;
  unsigned* flags;
  int K, B, U, H, S, N, CS, MB, NBUF;
  // streamed mode: depths a weight chunk and a rows chunk, resident
  // chunks a CTA
  int KC, RC, KR;
};

// x * y * (1 - y), evaluated left to right without contraction
__device__ __forceinline__ float mul_dsig(float x, float y) {
  return __fmul_rn(__fmul_rn(x, y), __fsub_rn(1.0f, y));
}

// Wb[u] at depth j (0..8H-1), state column t, as raw storage bits
template <typename T>
__device__ __forceinline__ unsigned wb_bits(const BwdParams<T>& p, int u,
                                            int j, int t) {
  const size_t i = ((size_t)u * 8 * p.H + j) * p.H + t;
  if (sizeof(T) == 4) return reinterpret_cast<const unsigned*>(p.wb)[i];
  return reinterpret_cast<const unsigned short*>(p.wb)[i];
}

// NT: n8 tiles of state columns, N / 8; STREAM: the streamed mode
template <typename T, int NT, bool STREAM>
__global__ void __launch_bounds__(STREAM ? STREAM_THREADS : THREADS, 1)
    wavefront_grid_bwd_kernel(const __grid_constant__ BwdParams<T> p) {
  constexpr bool TF32 = sizeof(T) == 4;
  constexpr int SETS = sets_for(NT);
  constexpr int NTHREADS = STREAM ? STREAM_THREADS : THREADS;
  constexpr int SEGS = 7;  // input segments a row: 4 gates, c, c_prev, dY
  const int K = p.K, B = p.B, H = p.H, N = p.N, CS = p.CS, MB = p.MB;
  // CTAs a unit: the streamed mode's last one may own fewer than N columns
  const int NBUF = p.NBUF, UH = p.U * H, G = 4 * UH;
  const int per_unit = (H + N - 1) / N;
  const int u = blockIdx.x / per_unit, t0 = (blockIdx.x % per_unit) * N;
  const int nv = min(N, H - t0);  // this CTA's columns
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int layer = p.lvec[u];
  const bool feed_out = u + 1 < p.U && p.lvec[u + 1] > 0;
  const int nstage = feed_out ? 8 : 4;  // unit u's gates, then unit u+1's
  const Layout L =
      STREAM ? stream_layout<T, false>(N, MB, CS, NBUF, p.KC, p.RC, p.KR)
             : grid_layout<T, false>(H, N, MB, NBUF);
  const int KTT = L.stages * L.kts;
  const int E = (B + MB - 1) / MB * K;
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
      STREAM ? p.wb + (units_tiles(u, per_unit, nc,
                                   [&](int v) {
                                     return v + 1 < p.U && p.lvec[v + 1] > 0
                                                ? 8
                                                : 4;
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
  float* dh_c = reinterpret_cast<float*>(smem + L.carry);  // [MB][N]
  float* dc_c = dh_c + MB * N;
  float* dht_c = dc_c + MB * N;  // dh_tot, which an idle unit carries

  if (STREAM)
    stream_init_barriers(bars, NBUF, CS);
  else
    grid_init_barriers(bars, NBUF, CS);
  // the rows' ring starts zeroed: a chunk shorter than KC leaves earlier
  // rows' (finite) values in its pieces past H, which meet zero weights
  for (int i = tid; i < (int)(((STREAM ? L.w : L.part) - L.buf) / 16);
       i += NTHREADS)
    reinterpret_cast<uint4*>(smem + L.buf)[i] = make_uint4(0, 0, 0, 0);
  // B fragments of the weight slice: [nt][KTT][lane][2], register r of lane
  // (g, t) holding W[d][n] at n = 8 nt + g, d = kw j + (t, or 2t and 2t+1
  // for bf16) (+kw/2 for r = 1); W[s H + d][c] = Wb[u][s H + d][t0 + c],
  // zero past H and for the feed stages of a unit that feeds none. The
  // streamed mode's tiles hold the same fragments, [nt][kpc][lane][2] a
  // chunk.
  for (int i = tid; !STREAM && i < L.nt * KTT * 64; i += NTHREADS) {
    const int r = i & 1, ln = (i >> 1) & 31, f = i >> 6;
    const int kt = f % KTT, ntile = f / KTT, s = kt / L.kts;
    const int c = ntile * 8 + ln / 4;
    int d = (kt % L.kts) * L.kw + r * (L.kw / 2);
    unsigned v = 0;
    if (TF32) {
      d += ln % 4;
      if (d < H && s < nstage) v = wb_bits(p, u, s * H + d, t0 + c);
    } else {
      d += 2 * (ln % 4);
      if (d < H && s < nstage)
        v = wb_bits(p, u, s * H + d, t0 + c) |
            wb_bits(p, u, s * H + d + 1, t0 + c) << 16;
    }
    w_s[i] = v;
  }
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
    // step, the inputs two steps ahead --
    const unsigned rank = CS > 1 ? cluster_rank() : 0;
    const unsigned short mask = (unsigned short)((1u << CS) - 1);
    const unsigned seg = H * sizeof(T);
    const unsigned ring_s = smem_addr(smem + L.buf);
    // step e's gates, c, c_prev and dY slices: per row SEGS segments of N
    // values, lane l taking segment l % 8 (none for 7) of rows l / 8, l / 8 +
    // 4, ..., 16 bytes a copy
    const int V = 16 / sizeof(T), q_in = lane % 8;
    const T* in_src = q_in < 4 ? p.gates_seq + q_in * UH
                               : q_in == 4 ? p.c_seq
                               : q_in == 5 ? p.c_prev_seq : p.dy;
    const size_t in_stride = q_in < 4 ? G : UH;
    auto inputs = [&](int e) {
      const int j = e & 1, k = K - 1 - e % K, r0 = e / K * MB;
      const int rows = min(MB, B - r0);
      if (q_in < SEGS)
        for (int m = lane / 8; m < rows; m += 4) {
          T* dst = in_s + ((size_t)(j * MB + m) * SEGS + q_in) * N;
          const T* src =
              in_src + ((size_t)k * B + r0 + m) * in_stride + u * H + t0;
          for (int v = 0; v < nv; v += V) cp_async16(dst + v, src + v);
        }
      cp_async_arrive(in_bar(bars, j));
    };
    int g = 0;
    inputs(0);
    if (E > 1) inputs(1);
    for (int e = 0; e < E; ++e) {
      const int k = K - 1 - e % K, r0 = e / K * MB, rows = min(MB, B - r0);
      for (int s = 0; STREAM && s < nstage; ++s) {
        const int unit = u + s / 4, q = s % 4;
        if (q == 0)
          wait_flag(p.flags + unit * FLAG_STRIDE, (e + 1) * per_unit, lane);
        for (int c = 0; c < ncr; ++c, ++g) {
          // slot g % NBUF of the rows' ring: rows chunk c's dgates columns
          // of gate q of `unit`
          const int slot = g % NBUF, use = g / NBUF;
          if (use > 0) mbar_wait(empty_bar(bars, slot), (use - 1) & 1);
          if (lane == 0)
            copy_rows(p.dmap, L, H, sizeof(T), c, q * p.U + unit, k, r0, rank,
                      CS, ring_s + slot * (unsigned)L.slot,
                      full_bar(bars, slot));
          __syncwarp();
        }
      }
      for (int s = 0; !STREAM && s < nstage; ++s, ++g) {
        const int unit = u + s / 4, q = s % 4;
        // dgates_seq[k] of `unit` is complete; for unit u this also says
        // that every CTA of the cluster is past its product of step e-1
        if (q == 0)
          wait_flag(p.flags + unit * FLAG_STRIDE, (e + 1) * per_unit, lane);
        const Slot sl = stage_slot(ring, NBUF, g, s, e);
        if (ring && sl.use > 0)
          mbar_wait(empty_bar(bars, sl.buf), (sl.use - 1) & 1);
        if (lane == 0) mbar_expect(full_bar(bars, sl.buf), rows * seg);
        __syncwarp();
        const unsigned dst = ring_s + sl.buf * L.rows * L.rs * sizeof(T);
        const T* src = p.dgates_seq + (size_t)k * B * G + q * UH + unit * H;
        for (int r = rank + CS * lane; r < rows; r += 32 * CS) {
          if (CS > 1)
            bulk_copy_mc(dst + r * L.rs * sizeof(T), src + (size_t)(r0 + r) * G,
                         seg, full_bar(bars, sl.buf), mask);
          else
            bulk_copy(dst + r * L.rs * sizeof(T), src + (size_t)(r0 + r) * G,
                      seg, full_bar(bars, sl.buf));
        }
      }
      // this CTA's cells of step e are done (its unit's flag counted them
      // above): step e+2's inputs take their buffer
      if (e + 2 < E) inputs(e + 2);
    }
  } else {
    // ---- consumers: the cells, then the product ----
    const int mtile = warp % L.mt, slice = warp / L.mt;
    // streamed mode: the rows slot's row this lane gives ldmatrix: row
    // 16 mtile + 8 ((l / 8) % 2) + l % 8, unit half l / 16 (matrices a0-a3:
    // rows g, g + 8 at k t, then at k t + 4); the rings' next slots and
    // their phases
    const SwzRow arow =
        STREAM ? swz_row(L, smem_addr(smem + L.buf),
                         mtile * 16 + ((lane >> 3) & 1) * 8 + (lane & 7))
               : SwzRow{0, 0};
    const unsigned ahalf = lane >> 4;
    int g = 0, rslot = 0, rpar = 0, wslot = 0, wpar = 0;
    for (int e = 0; e < E; ++e) {
      const int kk = e % K, k = K - 1 - kk, r0 = e / K * MB;
      const int rows = min(MB, B - r0);
      const bool valid = layer <= k && k < p.S + layer;
      mbar_wait(in_bar(bars, e & 1), (e >> 1) & 1);
      const T* xin = in_s + (size_t)(e & 1) * MB * SEGS * N;
      for (int cell = tid; cell < rows * N; cell += CONSUMERS) {
        const int m = cell / N, c = cell % N, row = r0 + m;
        const int col = u * H + t0 + c;
        if (c >= nv) continue;
        const T* x = xin + m * SEGS * N + c;
        float dh, dc;
        if (kk == 0) {
          dh = load_f32(p.dh0 + (size_t)row * UH + col);
          dc = load_f32(p.dc0 + (size_t)row * UH + col);
        } else {
          dh = dh_c[cell];
          dc = dc_c[cell];
        }
        const float dh_tot = __fadd_rn(dh, load_f32(x + 6 * N));
        const float ig = sigmoid(load_f32(x));
        const float fg = sigmoid(load_f32(x + N));
        const float gt = tanhf(load_f32(x + 2 * N));
        const float og = sigmoid(load_f32(x + 3 * N));
        const float tc = tanhf(load_f32(x + 4 * N));
        const float cprev = load_f32(x + 5 * N);
        const float d_o = __fmul_rn(dh_tot, tc);
        const float dct = __fadd_rn(
            dc, __fmul_rn(__fmul_rn(dh_tot, og),
                          __fsub_rn(1.0f, __fmul_rn(tc, tc))));
        float dg[4] = {0.f, 0.f, 0.f, 0.f};
        if (valid) {
          dg[0] = mul_dsig(__fmul_rn(dct, gt), ig);
          dg[1] = mul_dsig(__fmul_rn(dct, cprev), fg);
          dg[2] = __fmul_rn(__fmul_rn(dct, ig),
                            __fsub_rn(1.0f, __fmul_rn(gt, gt)));
          dg[3] = mul_dsig(d_o, og);
        }
        T* gp = p.dgates_seq + ((size_t)k * B + row) * G + col;
#pragma unroll
        for (int q = 0; q < 4; ++q) store(gp + q * UH, dg[q]);
        dc_c[cell] = round_to(valid ? __fmul_rn(dct, fg) : dc, p.dh0);
        dht_c[cell] = dh_tot;
      }
      consumers_sync();  // every dgates_seq[k] store of this CTA is issued
      if (tid == 0) publish_step(p.flags + u * FLAG_STRIDE);

      float acc[SETS][NT][3][4];
      zero_acc(acc);
      // streamed mode: each stage's rows chunks, each over its weight
      // chunks, the step's weight chunk i: the streamed ones (from their
      // ring) first, then the resident ones
      for (int s = 0, i = 0; STREAM && s < nstage; ++s) {
        for (int r = 0; r < ncr; ++r) {
          mbar_wait(full_bar(bars, rslot), rpar);
          const unsigned rs = smem_addr(smem + L.buf) + rslot * (unsigned)L.slot;
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
            const uint2* wb2 = reinterpret_cast<const uint2*>(wp) + lane;
#ifndef WAVEFRONT_STREAM_NO_PRODUCT
            // A: dgates of batch rows 16 mtile + g (+8) at the k-tile's 32
            // bytes (words t, t + 4)
            stage_product<T, NT, SETS>(
                acc, slice, kv, L.ks,
                [&](int j, unsigned (&a)[4]) {
                  ldsm_x4(swz_addr(L, arow, rs, p0, j, ahalf), a[0], a[1],
                          a[2], a[3]);
                },
                [&](int j, int n, unsigned (&b)[2]) {
                  const uint2 wv = wb2[(n * L.kpc + j) * 32];
                  b[0] = wv.x;
                  b[1] = wv.y;
                });
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
        // A: dgates of batch rows 16 mtile + g (+8) at depth kw j + t
        // (+4), or the bf16 pairs at 2t (+8): 32-bit words 8j + t, 8j + t
        // + 4 (a k-tile is 8 words in both); B: the weight fragments
        const unsigned* lo_row = reinterpret_cast<const unsigned*>(
            stg + (size_t)(mtile * 16 + g8) * L.rs);
        const unsigned* hi_row = reinterpret_cast<const unsigned*>(
            stg + (size_t)(mtile * 16 + g8 + 8) * L.rs);
        const uint2* wb2 = reinterpret_cast<const uint2*>(w_s) +
                           s * L.kts * 32 + lane;
        stage_product<T, NT, SETS>(
            acc, slice, L.kts, L.ks,
            [&](int j, unsigned (&a)[4]) {
              a[0] = lo_row[8 * j + t4];
              a[1] = hi_row[8 * j + t4];
              a[2] = lo_row[8 * j + t4 + 4];
              a[3] = hi_row[8 * j + t4 + 4];
            },
            [&](int j, int n, unsigned (&b)[2]) {
              const uint2 wv = wb2[(n * KTT + j) * 32];
              b[0] = wv.x;
              b[1] = wv.y;
            });
        if (ring) release_stage(empty_bar(bars, sl.buf), CS, warp, lane);
      }
      // this slice's sums: D[m][n] at row m = 16 mtile + g (+8), column
      // n = 8 nt + 2t (+1) -> part[slice][m][n]
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = mtile * 16 + g8 + (i / 2) * 8;
          const int c = n * 8 + 2 * t4 + i % 2;
          part[((size_t)slice * L.rows + m) * L.ps + c] =
              acc_sum(acc, n, i, TF32);
        }
      consumers_sync();
      for (int cell = tid; cell < rows * N; cell += CONSUMERS) {
        const int m = cell / N, c = cell % N, row = r0 + m;
        if (c >= nv) continue;
        const float* pp = part + (size_t)m * L.ps + c;
        float dz = pp[0];
        for (int s = 1; s < L.ks; ++s)
          dz = __fadd_rn(dz, pp[(size_t)s * L.rows * L.ps]);
        if (!valid) dz = __fadd_rn(dz, dht_c[cell]);  // idle: carries dh_tot
        dh_c[cell] = round_to(dz, p.dh0);
        if (kk == K - 1) {
          const size_t off = (size_t)row * UH + u * H + t0 + c;
          store(p.dh_fin + off, dz);
          store(p.dc_fin + off, dc_c[cell]);
        }
      }
    }
  }
  grid_end(CS);
}

// the kernel for N state columns a CTA: N in {8, 16, 32} resident, also 64
// streamed
template <typename T, bool STREAM>
const void* kernel_for(int N) {
  switch (N) {
    case 8: return (const void*)wavefront_grid_bwd_kernel<T, 1, STREAM>;
    case 16: return (const void*)wavefront_grid_bwd_kernel<T, 2, STREAM>;
    case 32: return (const void*)wavefront_grid_bwd_kernel<T, 4, STREAM>;
    case 64:
      return STREAM ? (const void*)wavefront_grid_bwd_kernel<T, 8, true>
                    : nullptr;
  }
  return nullptr;
}

template <typename T, bool STREAM>
int launch(const void* wb, const void* gates_seq, const void* c_seq,
           const void* c_prev_seq, const void* dy, const void* dh0,
           const void* dc0, const void* lvec, void* dgates_seq, void* dh_fin,
           void* dc_fin, void* flags, int K, int B, int U, int H, int S, int N,
           int CS, int MB, int NBUF, int KC, int RC, int KR, int smem,
           void* stream) {
  const int item = (int)sizeof(T);
  const Layout L = STREAM ? stream_layout<T, false>(N, MB, CS, NBUF, KC, RC, KR)
                          : grid_layout<T, false>(H, N, MB, NBUF);
  if (STREAM ? !stream_args_ok(H, N, CS, MB, NBUF, KC, RC, KR, item, smem,
                               L.total)
             : !grid_args_ok(H, N, CS, MB, NBUF, smem, L.total))
    return (int)cudaErrorInvalidValue;
  BwdParams<T> p = {};
  p.wb = (const T*)wb;
  p.gates_seq = (const T*)gates_seq;
  p.c_seq = (const T*)c_seq;
  p.c_prev_seq = (const T*)c_prev_seq;
  p.dy = (const T*)dy;
  p.dh0 = (const T*)dh0;
  p.dc0 = (const T*)dc0;
  p.lvec = (const int*)lvec;
  p.dgates_seq = (T*)dgates_seq;
  p.dh_fin = (T*)dh_fin;
  p.dc_fin = (T*)dc_fin;
  p.flags = (unsigned*)flags;
  p.K = K, p.B = B, p.U = U, p.H = H, p.S = S, p.N = N, p.CS = CS;
  p.MB = MB, p.NBUF = NBUF, p.KC = KC, p.RC = RC, p.KR = KR;
  if (STREAM) {  // dgates rows at 4 U H values (gate-major), B rows a step
    const size_t row = (size_t)4 * U * H * item;
    const int err = row_maps<T>(&p.dmap, dgates_seq, H, 4 * U, B, K, row,
                                (size_t)B * row, L);
    if (err) return err;
  }
  return grid_launch(kernel_for<T, STREAM>(N), &p, U * ((H + N - 1) / N), CS,
                     smem, stream, STREAM ? STREAM_THREADS : THREADS);
}

}  // namespace

#define GRID_BWD_ARGS                                                       \
  const void *wb, const void *gates_seq, const void *c_seq,                \
      const void *c_prev_seq, const void *dy, const void *dh0,             \
      const void *dc0, const void *lvec, void *dgates_seq, void *dh_fin,   \
      void *dc_fin, void *flags, int K, int B, int U, int H, int S, int N, \
      int CS, int MB, int NBUF

extern "C" int wavefront_grid_bwd_f32(GRID_BWD_ARGS, int smem, void* stream) {
  return launch<float, false>(wb, gates_seq, c_seq, c_prev_seq, dy, dh0, dc0,
                              lvec, dgates_seq, dh_fin, dc_fin, flags, K, B,
                              U, H, S, N, CS, MB, NBUF, 0, 0, 0, smem, stream);
}

extern "C" int wavefront_grid_bwd_bf16(GRID_BWD_ARGS, int smem, void* stream) {
  return launch<__nv_bfloat16, false>(wb, gates_seq, c_seq, c_prev_seq, dy,
                                      dh0, dc0, lvec, dgates_seq, dh_fin,
                                      dc_fin, flags, K, B, U, H, S, N, CS, MB,
                                      NBUF, 0, 0, 0, smem, stream);
}

// The streamed mode: `wb` is the wrapper's tiles (kernels/wavefront.py::
// _stream_tiles), NBUF the slots of each of its rings (rows, weights), KC
// the depths of a weight chunk, RC those of a rows chunk (whole weight
// chunks), KR the resident chunks a CTA; the other arguments as above.
// Returns the CUDA error of the launch, or 10000 + the CUresult of
// cuTensorMapEncodeTiled where it refuses a tensor map.
extern "C" int wavefront_grid_bwd_stream_f32(GRID_BWD_ARGS, int KC, int RC,
                                             int KR, int smem, void* stream) {
  return launch<float, true>(wb, gates_seq, c_seq, c_prev_seq, dy, dh0, dc0,
                             lvec, dgates_seq, dh_fin, dc_fin, flags, K, B, U,
                             H, S, N, CS, MB, NBUF, KC, RC, KR, smem, stream);
}

extern "C" int wavefront_grid_bwd_stream_bf16(GRID_BWD_ARGS, int KC, int RC,
                                              int KR, int smem, void* stream) {
  return launch<__nv_bfloat16, true>(wb, gates_seq, c_seq, c_prev_seq, dy,
                                     dh0, dc0, lvec, dgates_seq, dh_fin,
                                     dc_fin, flags, K, B, U, H, S, N, CS, MB,
                                     NBUF, KC, RC, KR, smem, stream);
}

// How many CTAs of the reverse wavefront (four n8 tiles) the card holds at
// once in clusters of CS with `smem` bytes of shared memory, or minus the
// CUDA error. The narrower ones have the same shared memory and no more
// registers.
extern "C" int wavefront_grid_bwd_max_ctas(int bf16, int CS, int smem) {
  return grid_max_ctas(bf16 ? kernel_for<__nv_bfloat16, false>(32)
                            : kernel_for<float, false>(32),
                       smem, CS);
}

// ... of the streamed reverse wavefront (eight n8 tiles)
extern "C" int wavefront_grid_bwd_stream_max_ctas(int bf16, int CS,
                                                  int smem) {
  return grid_max_ctas(bf16 ? kernel_for<__nv_bfloat16, true>(64)
                            : kernel_for<float, true>(64),
                       smem, CS, STREAM_THREADS);
}
