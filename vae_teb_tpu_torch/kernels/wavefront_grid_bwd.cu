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
// the stages' chunks through a ring of slots, each slot a chunk's weight
// tile and the chunk's KC columns of the stage's dgates rows. Only the
// summation order differs from the resident mode (each warp's accumulator
// sets restart their k-tile count at every chunk); the plain version
// (kernels/wavefront_ref.py::wavefront_bwd_plain) is its oracle.
//
// Plain C interface: each entry point launches on the given stream and
// returns the CUDA error of the launch (0 on success).

#include "wavefront_grid.cuh"

namespace {

template <typename T>
struct BwdParams {
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
  int KC;  // streamed mode: depths a chunk
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
__global__ void __launch_bounds__(THREADS, 1)
    wavefront_grid_bwd_kernel(const BwdParams<T> p) {
  constexpr bool TF32 = sizeof(T) == 4;
  constexpr int SETS = sets_for(NT);
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
  const Layout L = STREAM ? stream_layout<T, false>(H, N, MB, NBUF, p.KC)
                          : grid_layout<T, false>(H, N, MB, NBUF);
  const int KTT = L.stages * L.kts;
  const int E = (B + MB - 1) / MB * K;
  // streamed mode: chunks a stage, and this CTA's first weight tile
  const int nc = STREAM ? (H + p.KC - 1) / p.KC : 0;
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

  grid_init_barriers(bars, NBUF, CS, STREAM ? WARPS : 1);
  // the ring starts zeroed: a chunk shorter than KC leaves earlier rows'
  // (finite) values past its end, which meet zero weights
  for (int i = tid; i < (int)((L.part - L.buf) / 16); i += THREADS)
    reinterpret_cast<uint4*>(smem + L.buf)[i] = make_uint4(0, 0, 0, 0);
  // B fragments of the weight slice: [nt][KTT][lane][2], register r of lane
  // (g, t) holding W[d][n] at n = 8 nt + g, d = kw j + (t, or 2t and 2t+1
  // for bf16) (+kw/2 for r = 1); W[s H + d][c] = Wb[u][s H + d][t0 + c],
  // zero past H and for the feed stages of a unit that feeds none. The
  // streamed mode's tiles hold the same fragments, [nt][kpc][lane][2] a
  // chunk.
  for (int i = tid; !STREAM && i < L.nt * KTT * 64; i += THREADS) {
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

  if (warp == WARPS) {
    // ---- producer: the stages of every step, the inputs two steps ahead --
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
        const T* src = p.dgates_seq + (size_t)k * B * G + q * UH + unit * H;
        for (int c = 0; c < nc; ++c, ++g) {
          // slot g % NBUF: the chunk's weight tile, then its dgates columns
          const int slot = g % NBUF, use = g / NBUF;
          if (use > 0) mbar_wait(empty_bar(bars, slot), (use - 1) & 1);
          const unsigned bytes = min(p.KC, H - c * p.KC) * sizeof(T);
          const unsigned dst = ring_s + slot * L.slot;
          if (lane == 0) {
            mbar_expect(full_bar(bars, slot), rows * bytes + L.wt);
            bulk_copy(dst, tiles + (size_t)(s * nc + c) * tile, L.wt,
                      full_bar(bars, slot));
          }
          __syncwarp();
          for (int r = rank + CS * lane; r < rows; r += 32 * CS) {
            const T* row = src + (size_t)(r0 + r) * G + c * p.KC;
            const unsigned at = dst + L.wt + r * L.rsc * sizeof(T);
            if (CS > 1)
              bulk_copy_mc(at, row, bytes, full_bar(bars, slot), mask);
            else
              bulk_copy(at, row, bytes, full_bar(bars, slot));
          }
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
    int g = 0;
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
      for (int s = 0; STREAM && s < nstage; ++s) {
        for (int c = 0; c < nc; ++c, ++g) {
          const int slot = g % NBUF;
          mbar_wait(full_bar(bars, slot), (g / NBUF) & 1);
          const int kv = (min(p.KC, H - c * p.KC) + L.kw - 1) / L.kw;
          const unsigned char* sp = smem + L.buf + (size_t)slot * L.slot;
          const T* stg = reinterpret_cast<const T*>(sp + L.wt);
          const unsigned* lo_row = reinterpret_cast<const unsigned*>(
              stg + (size_t)(mtile * 16 + g8) * L.rsc);
          const unsigned* hi_row = reinterpret_cast<const unsigned*>(
              stg + (size_t)(mtile * 16 + g8 + 8) * L.rsc);
          const uint2* wb2 = reinterpret_cast<const uint2*>(sp) + lane;
          stage_product<T, NT, SETS>(
              acc, slice, kv, L.ks,
              [&](int j, unsigned (&a)[4]) {
                a[0] = lo_row[8 * j + t4];
                a[1] = hi_row[8 * j + t4];
                a[2] = lo_row[8 * j + t4 + 4];
                a[3] = hi_row[8 * j + t4 + 4];
              },
              [&](int j, int n, unsigned (&b)[2]) {
                const uint2 wv = wb2[(n * L.kpc + j) * 32];
                b[0] = wv.x;
                b[1] = wv.y;
              });
          release_slot(empty_bar(bars, slot), CS, lane);
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
           int CS, int MB, int NBUF, int KC, int smem, void* stream) {
  const Layout L = STREAM ? stream_layout<T, false>(H, N, MB, NBUF, KC)
                          : grid_layout<T, false>(H, N, MB, NBUF);
  if (STREAM ? !stream_args_ok(H, N, CS, MB, NBUF, KC, L.kw, smem, L.total)
             : !grid_args_ok(H, N, CS, MB, NBUF, smem, L.total))
    return (int)cudaErrorInvalidValue;
  BwdParams<T> p = {(const T*)wb,        (const T*)gates_seq,
                    (const T*)c_seq,     (const T*)c_prev_seq,
                    (const T*)dy,        (const T*)dh0,
                    (const T*)dc0,       (const int*)lvec,
                    (T*)dgates_seq,      (T*)dh_fin,
                    (T*)dc_fin,          (unsigned*)flags,
                    K, B, U, H, S, N, CS, MB, NBUF, KC};
  return grid_launch(kernel_for<T, STREAM>(N), &p, U * ((H + N - 1) / N), CS,
                     smem, stream);
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
                              U, H, S, N, CS, MB, NBUF, 0, smem, stream);
}

extern "C" int wavefront_grid_bwd_bf16(GRID_BWD_ARGS, int smem, void* stream) {
  return launch<__nv_bfloat16, false>(wb, gates_seq, c_seq, c_prev_seq, dy,
                                      dh0, dc0, lvec, dgates_seq, dh_fin,
                                      dc_fin, flags, K, B, U, H, S, N, CS, MB,
                                      NBUF, 0, smem, stream);
}

// The streamed mode: `wb` is the wrapper's tiles (kernels/wavefront.py::
// _stream_tiles), KC the depths of a chunk; the other arguments as above
extern "C" int wavefront_grid_bwd_stream_f32(GRID_BWD_ARGS, int KC, int smem,
                                             void* stream) {
  return launch<float, true>(wb, gates_seq, c_seq, c_prev_seq, dy, dh0, dc0,
                             lvec, dgates_seq, dh_fin, dc_fin, flags, K, B, U,
                             H, S, N, CS, MB, NBUF, KC, smem, stream);
}

extern "C" int wavefront_grid_bwd_stream_bf16(GRID_BWD_ARGS, int KC, int smem,
                                              void* stream) {
  return launch<__nv_bfloat16, true>(wb, gates_seq, c_seq, c_prev_seq, dy,
                                     dh0, dc0, lvec, dgates_seq, dh_fin,
                                     dc_fin, flags, K, B, U, H, S, N, CS, MB,
                                     NBUF, KC, smem, stream);
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
                       smem, CS);
}
